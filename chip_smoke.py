"""On-card smoke test of the PyTorch/CUDA port (njode_tpu_torch) on one H100.

    python3 chip_smoke.py            # every phase, one card, no arguments

Phases, one line each, then the ``kernels`` JSON line, the card's name and
power limit, and the final ``{"ok": true, ...}`` line:

1. device   - a CUDA card must be present (else exit 1, no result);
2. build    - nvcc builds ops/csrc/fused_scan.cu for sm_90a;
3. kernels  - every kernel against its plain PyTorch version at the main
              path's shapes (B=200, K=100, D=1, H=10, W=50, S=8, dropout
              0.1; the eval forward at B=4,000), in both mask modes, each
              kernel run twice and compared bit for bit, at the rows the
              rule takes (one a CTA at B=100 and 200, 16 at B=4,000), each
              launch's CTAs an SM held against what
              cudaOccupancyMaxActiveBlocksPerMultiprocessor reports (no
              launch the rule puts on one wave may take a second);
              reduce_partials bit for bit its plain version at the
              gradient partials of the main path and the PhysioNet 50 arm
              at one row a CTA ([100, 10,071], [50, 24,423]), at 16 rows
              ([13, 10,071], [4, 24,423]) and of the climate 400 arm
              ([25, 571,305]);
4. timing   - CUDA-event times of each kernel and its plain version, and
              the least time the card could take (bound); reduce_partials'
              device time per launch beside sum(dim=0)'s, both from
              torch.profiler (or, where it records none, CUDA events with
              the launches queued behind a device sleep), and the old
              host-loop yardstick; K4's
              standalone kernel by that device time beside its
              host-loop time; the masks' cost inside K1 and K2 at the
              trainer's batch (``mask_cost``: each with dropout off, in
              'input' mode fed with K4's written-out masks and in 'prng'
              mode, which must give the same bits);
5. trainer  - njode_tpu_torch.training.trainer.train on a 20,000-path
              BlackScholes dataset, 2 epochs of batch 100 with 'prng'
              dropout masks; losses must be finite, the launch counts
              of the main path's kernels what 2 epochs need, and every
              launch at the rows the rule takes at its batch; then
              (rnn_trainer) the same run with the GRU jump (use_rnn), its
              launches exact under the '_rnn' keys; and (chunk) the
              first run again with epoch_chunk=2 (train_epochs), its
              launch counts exact and the same, its metric rows (but the
              times) and both checkpoints' tensors held to the per-epoch
              run's (rtol 1e-6; printed: equal bit for bit or not);
6. rnn_kernels - the GRU jump of K1, K2 and K3 against their plain
              versions at the main path's widths (B=200, K=100, both mask
              modes; K3 also at B=4,000), each run twice bit for bit, and
              the global plan bit for bit against the resident plan, both
              forced at 16 rows, and forced at the rule's rows (one a CTA)
              against the rule's own launch;
7. rnn_timing - CUDA-event times and bounds of those three kernels;
8. gob_kernels - the GRU-ODE-Bayes kernels (ops/csrc/fused_gob.cu: K5
              forward, K6 backward in three stages, K7 masks) against their
              plain versions at the published widths (D=1, hidden 50 and
              100 with p_hidden = prep_hidden = cov_hidden = hidden, full
              field, logvar, mixing 1e-4 and 0.5, impute on and off,
              dropout 0.1, B=20, K=100) at the rows the rule takes (one a
              CTA), again forced to 8 rows (hidden 50) and 4 (hidden 100,
              the most that fit), and at the two wide configurations (D=1
              at widths 200, D=41 at widths 50), in both mask modes, each
              run twice and compared bit for bit; K6's stages against
              their plain version (gob_scan_bwd_staged_plain: stage (a)'s
              saved buffers and stage (b)'s deltas buffer by buffer, stage
              (c)'s gradients); K5's eval form at B=2,000 (the validation
              split of the default 10,000-path dataset);
9. gob_timing - CUDA-event times of K5, K5 eval, K6 and their plain
              versions, K6's stages' device times (torch.profiler) beside
              the plain version of each stage and, for stage (c), the
              device time of its jobs as torch.matmul calls; K7's device
              time at the trainer's shape and the climate GOB arm's; the
              masks' cost inside K5 and K6 (``mask_cost``); the bound of
              each;
10. gob_trainer - trainer.train(other_model="GRU_ODE_Bayes", hidden 50,
              batch 20, dropout 0.1, impute, logvar, mixing 1e-4) on a
              10,000-path BlackScholes dataset (8,000 train paths, 400 steps
              an epoch) for 2 epochs; losses and evaluation_mean_diff
              finite, optimal_eval_loss NaN by design, and the launch counts
              exactly what 2 epochs need (K6's three stages once a chunk of
              steps, ``BwdChunks``); then (gob_chunk) again with
              epoch_chunk=2, held to it as the NJODE chunk is;
11. sync     - one train_epochs call of 2 epochs (no oracle difference)
              under torch.cuda.set_sync_debug_mode("error"), after a
              warm-up call: NJODE at the main path's widths (B = 100) must
              make the host wait nowhere; the GOB call (hidden 50, B = 20)
              is reported, with the line that made it wait if one did; a
              read back (.item()) under the check must be caught;
12. busy     - the device's busy share (torch.profiler: kernel and copy
              time over the host time of the window) over one epoch
              queued through train_epoch and one train_epochs chunk: NJODE
              at the bench's shape (16,000 paths, B = 200, chunk of 7),
              GOB at the trainer's widths (2,000 paths, B = 20, chunk of 2);
13. bench    - njode_tpu_torch.bench.main() at its shape, its card line
              and JSON line printed as [bench] lines, with exact launch
              counts (80 K1 and K2 an epoch, one K3 a chunked epoch);
14. climate_kernels - on the full-scale climate stand-in (1,114 series, 5
              variables, T = 200, obs_perc 0.02; fold 0; the first training
              batch of epoch 1, B = 100, K = 2,004 grid steps): the masked
              branch of K1, K2 and K3 against their plain versions at the
              climate widths (D 5, hidden 10, three 2x50 tanh MLPs, dropout
              0.1) over the first 100 steps in both mask modes and over all
              2,004 steps in 'prng' mode, and K5/K6 at the GRU-ODE-Bayes
              climate arm (D 5, hidden 50, p_hidden 25, prep_hidden 10,
              cov_hidden 50, full field, impute off, logvar, mixing 1e-4,
              dropout 0.2) over the first 100 steps in both mask modes and
              over all 2,004 steps in 'prng' mode (the trainer's shape);
              each kernel run twice and compared bit for bit;
15. climate_timing - CUDA-event times and bounds of the masked K1/K2/K3
              and of K5/K6 at the climate arms, B = 100, K = 2,004, and the
              masks' cost inside K1/K2 and K5/K6 there (``mask_cost``);
16. climate_trainer - climate_trainer.train on the stand-in, fold 0, 2
              epochs of batch 100, the NJODE small arm and then the
              GRU-ODE-Bayes arm; losses and eval_metric finite, and the
              launch counts exactly what the epochs' batches need (so an
              eager fallback on this path fails the run);
17. climate_rnn - the masked GRU jump at the climate small arm: K1-K3
              against their plain versions over the first 100 steps of the
              first climate batch in both modes, their times and bounds
              over all 2,004 steps, and one epoch of
              climate_trainer.train(use_rnn=True) with exact launch counts;
18. physionet_setup - the PhysioNet stand-in at the published scale
              (8,000 records of 41 variables, quantization 0.016 h, seed
              0), the 80/20 split, the pre-stacked bank (K = 3,006 grid
              steps) and the first training batch of epoch 1 (B = 50);
19. physionet_kernels - K1, K2 and K3 in the global plan (weights in
              device memory, staged through the ring) against their plain
              versions: the PhysioNet 50 arm (D = hidden = 41, three 2x50
              tanh MLPs, dropout 0.1; forced into the global plan at 16
              rows, the rule takes the resident plan at one row a CTA)
              over the first 100 steps in both mask modes and over all
              3,006 in 'prng' mode, step by step (``STEP_TOL``), the 200
              arm and the
              climate 400 arm (on the first climate batch) over the first
              100 steps in both modes, each kernel run twice and compared
              bit for bit; the 50 arm in the rule's resident plan (one row
              a CTA) over 100 steps; and the global plan bit for bit
              against the resident plan (both at 16 rows, and at the
              rule's rows against the rule's launch) on the main path and
              on the climate small arm;
20. physionet_timing - CUDA-event times and bounds of the global plan's
              K1/K2/K3 at the 50 arm (forced, 16 rows) and the 200 arm
              (B = 50, K = 3,006) and at the climate 400 arm (B = 100,
              K = 2,004), and of the 50 arm in the rule's resident plan
              (one row a CTA), with the masks' cost inside its K1/K2
              (``mask_cost``);
21. physionet_trainer - physionet_trainer.train at the 50 arm (batch 50,
              'prng', the resident plan, one row a CTA) for 2 epochs on the
              stand-in cut to 1,000 records (800 train, 16 batches an
              epoch); losses and both metrics finite, and the launch counts
              exact;
22. physionet_rnn - the masked GRU jump at the 50 arm in the global plan:
              K1-K3 against their plain versions over the first 100 steps
              in both modes, their times and bounds over all 3,006, and one
              epoch of physionet_trainer.train(use_rnn=True) with exact
              launch counts (the global plan's trainer path);
23. sweep    - the published grids of njode_tpu_torch/experiments/
              configs.py at their widths and hyperparameters, their
              datasets created on the card (3 base, 2 HestonWOFeller, the
              combined and 2 sine datasets, 20,000 paths each), and 15 of
              their entries driven through training/sweeps.
              parallel_training, cut to one epoch (save_every 1): every
              width of the convergence study (10-320, B = 20, its smallest
              training size, 200), one NJODE and one GRU-ODE-Bayes entry
              of the GOB comparison (hidden 50, impute, logvar, mixing
              1e-4), both HestonWOFeller entries (D = 1 and the 2-D
              return_vol set), the combined regime (2x100), both sine
              entries (2x400; 1,000 training paths at B = 20 and 2,000 at
              B = 100), fold 0 of the climate small arm on the stand-in
              and a PhysioNet 50-arm entry on 1,000 stand-in records (the
              'records' live key); each run's result must be 0, its metric
              row finite, its launch counts exact under the key of the
              plan it takes (the global plan at widths 100, 160, 320 and
              400), every scan launch at the rule's rows, and, where
              matplotlib is missing, its figures skipped with one printed
              line and none written; then K1 and K2 (with K3) against
              their plain versions in 'input' mode, each twice bit for
              bit, at the sine 400 arm's shape (B = 100, global / 4) and
              widths 320 and 160 at B = 20 (global / 8 and 16), with their
              CUDA-event times, bounds, rows, CTAs and waves; the two
              convergence widths timed again forced to one row a CTA;
24. groups   - the grouped ensembles (training/group_sweep.py,
              climate_group.py, physionet_group.py): K1 and K2 over a
              member axis (one launch of grid (ceil(B/R), E) for E
              members) at E = 3, in both mask modes, each member bit for
              bit its own solo launches at the same rows and the member
              launch twice bit for bit, and within the North-star
              tolerances of the member plain version, at the main path
              (B = 100), the convergence study's width 320 (global / 8,
              B = 20), the climate small arm (B = 100, K = 2,004; the
              plain version over the first 100 steps, LONG_TOL) and the
              main path with the GRU jump; the member launch of K1/K2 at
              E = 5 timed against five solo launches (CUDA events) at
              widths 320 and 40 (B = 20), the main path (B = 100) and the
              PhysioNet 50 arm (B = 50, K = 3,006), with E times the solo
              bound; the member reduce_partials bit for bit its plain
              version and timed (device time) beside five solo launches
              and sum(dim=1); then sweeps.parallel_training(
              vmap_groups=True), one epoch each: a convergence cell
              (width 320, training size 200, B = 20, 5 repeats), the
              climate small arm's 5 folds on the stand-in, the PhysioNet
              50 arm x 2 repeats on 1,000 records; every result 0, every
              member's row finite, the launch counts exact (one member
              launch of K1 and of K2 a step: a group that fell back to
              solo runs fails them), and one convergence member's metric
              row bit for bit a solo run of its params.

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
check the same way); in the climate phase each gradient leaf takes the
atol scaled by its own largest |value|. Over the climate grid's 2,004
steps the masked kernels are held to ``LONG_TOL`` (see there), and over
the PhysioNet grid's 3,006 step by step (``STEP_TOL``). The two plans sum
in the same order, so at one row count they must agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
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
# K = 2,004 (the climate grid): the loss keeps its tolerance; the carry
# histories and the gradients are sums over up to 2,004 fp32 steps whose
# products the kernel adds serially and the plain version through cuBLAS,
# so their error grows with the size of the sum: rtol 2e-4 and an atol of
# 2e-5 scaled by the largest |value| of each history and of each gradient
# leaf (None: scaled_tol of that reference). The climate_kernels lines
# print the share of this tolerance each check used (PERF.md records it).
LONG_TOL = dict(loss=LOSS_TOL, hist=None, grad=None)
# K = 3,006 (the PhysioNet grid): at D = H = 41 the residual encoder and
# readout make every jump h -> h + g(h) on the unobserved coordinates, and
# over hundreds of jumps a record's state amplifies rounding until two
# fp32 scans that sum in different orders part ways (the plain version
# among them; PERF.md). K1 and K3 are then checked step by step: the plain
# step map from each of the kernel's own step-entry carries
# (fused_scan.scan_steps_plain) must give its next carry and, summed, its
# loss, at LONG_TOL. K2 re-runs each step from K1's carries, as its plain
# version does, and is checked as on the climate grid.
STEP_TOL = dict(LONG_TOL, stepwise=True)
SHORT_TOL = dict(loss=LOSS_TOL, hist=GRAD_TOL, grad=GRAD_TOL)
# The PhysioNet arms (D = H = 41) over their first 100 steps: the same
# amplification already parts two fp32 scans by more than GRAD_TOL on some
# draws (the 200 arm's histories, PERF.md), so there too K1 and K3 are
# checked step by step, at SHORT_TOL; K2 is held to GRAD_TOL as before.
SHORT_STEP_TOL = dict(SHORT_TOL, stepwise=True)
CLIMATE_SERIES = 1114      # the published scale of the USHCN file
CLIMATE_B = 100
# PhysioNet (experiments/configs.py physionet_comparison): set-a + set-b at
# n_samples 8,000, quantization 0.016 h, batch 50; the trainer phase's cut
PHYS_RECORDS = 8000
PHYS_QUANT = 0.016
PHYS_T = 1 + 1e-12
PHYS_B = 50
PHYS_TRAIN_RECORDS = 1000
PHYS_200_RECORDS = 400     # the stand-in cut for the 200 arm's one epoch
# reduce_partials' shapes: the gradient partials of the main path's
# trainer (B = 100, one row a CTA) and the PhysioNet 50 arm (B = 50, one
# row a CTA), then at 16 rows a CTA: the main path at B = 200 and the
# PhysioNet 50 arm; and the climate 400 arm (B = 100 at 4 rows)
REDUCE_SHAPES = ((100, 10071), (50, 24423), (13, 10071), (4, 24423),
                 (25, 571305))


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


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


def timed(fn):
    """``(fn(), its CUDA-event ms)`` of one call (no warm-up: for the plain
    versions' long single runs)."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


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


def main_path_setup(B, K, seed, device, use_rnn=False, width=50,
                    data=("BlackScholes", {})):
    """Main-path model (with the GRU jump: ``use_rnn``; three 2 x ``width``
    tanh MLPs; input = output = the dataset's dimension D) and a batch of
    ``data`` = (SDE model name, hyperparameters over the defaults) on the
    card (BlackScholes, D = 1, unless asked otherwise)."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid, sde
    from njode_tpu_torch.data.datasets import hyperparam_default
    from njode_tpu_torch.models.njode import NJODE, NJODEConfig

    name, over = data
    hp = dict(hyperparam_default, **over, nb_paths=B, nb_steps=K)
    D = hp["dimension"]
    nn_desc = ((width, "tanh"), (width, "tanh"))
    cfg = NJODEConfig(D, 10, D, nn_desc, nn_desc, nn_desc,
                      dropout_rate=0.1, use_rnn=use_rnn)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = NJODE(cfg).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths, dt = sde.make_model(name, hp).generate_paths(gen)
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
    say("kernels", K3_loss_err=f"{e3:.3e}", K3_loss=f"{float(l3[0]):.6f}")
    for Bw in (100, B, B3):
        check_waves("kernels", "main_path", cfg, Bw)
    # reduce_partials at REDUCE_SHAPES: its plain version's bits (the rows
    # summed in ascending order), run after run
    parts = {}
    for n_parts, n in REDUCE_SHAPES:
        P = torch.randn((n_parts, n), generator=gen, device=dev)
        r1, r2 = fs.reduce_partials_cuda(P), fs.reduce_partials_cuda(P)
        torch.cuda.synchronize()
        if not (torch.equal(r1, r2)
                and torch.equal(r1, fs.reduce_partials_plain(P))):
            raise AssertionError(f"reduce_partials [{n_parts}, {n}] differs "
                                 "from its plain version or between runs")
        parts[(n_parts, n)] = P
        say("kernels", reduce_shape=f"[{n_parts},{n}]", bit_equal=True,
            bitwise_repeat=True)
    e_red = 0.0
    results["setup"] = dict(cfg=cfg, model=model, batch=batch,
                            leaves=leaves, arrays=arrays, h0=h0,
                            arrays3=arrays3, leaves3=leaves3, h03=h03,
                            spec3=spec3, parts=parts, seed=seed_p)
    results["errs"] = dict(
        K1=max(errs[m]["loss"] for m in errs),
        K2=max(max(errs[m]["grad"], errs[m]["dh0"]) for m in errs),
        K3=e3, K4=float(n_bad), reduce=e_red)


def _macs_per_row_step(spec):
    """MACs of one forward step for one batch row: the ODE MLP, the jump
    (the encoder, or the GRU's three gates over [X, h]) and both
    readouts."""
    def macs(ws):
        return sum(a * b for a, b in zip(ws[:-1], ws[1:]))
    jump = (3 * spec.H * (spec.D + spec.H) if spec.use_rnn
            else macs(spec.enc_w))
    return macs(spec.ode_w) + jump + 2 * macs(spec.ro_w)


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
    t["K4"] = (mask_kernel_ms("timing", "philox_masks_kernel", lambda:
                              fs.philox_masks_cuda(seed, K, spec.S, B,
                                                   spec.w_max, spec.thresh),
                              f"[{K},{spec.S},{B},{spec.w_max}]"),
               cuda_ms(lambda: fs.philox_keep_plain(
                   int(seed), karange, spec.S, B, spec.w_max, spec.thresh,
                   h0.device), 3, 1))
    red = reduce_times(st["parts"])
    main_shape = REDUCE_SHAPES[0]
    t["reduce"] = (red[main_shape]["device_ms"], red[main_shape]["plain_ms"])
    lib_ms = red[main_shape]["library_device_ms"]
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
    mask_cost_njode("timing", "main_path", cfg, leaves, arr_t, h0_t, 20)

    # bounds: max(operations / peak, bytes / bandwidth), each input read
    # once and each output written once
    mac = _macs_per_row_step(spec)
    P = spec.n_params
    in_bytes = 4 * (2 * K + K * B + K * B * spec.D + B + B * spec.D
                    + B * spec.H + P) + 8
    hist_bytes = 4 * K * B * (spec.H + spec.D + 1)
    f1 = 2.0 * mac * B * K
    b1 = in_bytes + hist_bytes + 4 * -(-B // spec.rows_for(B, False))
    # backward: the recomputed forward, plus dW and dx per linear
    f2 = 3.0 * f1
    b2 = (in_bytes + hist_bytes + 4 + 4 * -(-B // spec.rows_for(B)) * P
          + 4 * B * spec.H)
    f3 = 2.0 * mac * B3 * K3
    b3 = 4 * (2 * K3 + K3 * B3 * 2 + B3 * 2 + B3 * spec.H + P)
    n_mask = K * spec.S * B * spec.w_max
    # one Philox4x32-10 (10 rounds x 8 ops + 18 key adds) per 4 mask words,
    # plus one compare per element
    f4 = n_mask * (98.0 / 4 + 1)
    b4 = n_mask + 8
    n_parts, n = main_shape
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


def mask_kernel_ms(phase, kern, fn, shape):
    """Device ms per call of a standalone mask kernel (K4's
    ``philox_masks_kernel``, K7's ``gob_masks_kernel``: :func:`kernel_ms`),
    printed beside :func:`queued_ms` (the profiler's stand-in, run here
    every time) and the old yardstick, CUDA events around a loop of
    wrapper calls (host time included)."""
    dev_ms = kernel_ms(fn, kern)
    say(phase, kernel=kern, shape=shape, device_ms=f"{dev_ms:.5f}",
        queued_ms=f"{queued_ms(fn):.5f}",
        host_loop_ms=f"{cuda_ms(fn, 50):.5f}")
    return dev_ms


def _mask_cost(phase, arm, names, runs, reps):
    """Each of ``runs`` ({mode: (fwd, bwd)}: the kernels ``names`` on
    the same inputs with dropout off, in 'input' mode on the standalone
    kernel's masks and in 'prng' mode) once for its outputs, then timed
    (CUDA events, one warm-up and ``reps`` calls); fails unless 'input'
    and 'prng' give the same bits; prints the times and the masks' cost
    (prng - off) and returns the ms."""
    import torch

    outs, ms = {}, {}
    for mode, (fwd, bwd) in runs.items():
        loss, hists = fwd()
        outs[mode] = (loss, *hists, *bwd())
        ms[mode] = (cuda_ms(fwd, reps, 1), cuda_ms(bwd, reps, 1))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs["prng"],
                                                 outs["input"]))
    if not same:
        raise AssertionError(f"{phase} {arm}: 'prng' and 'input' on its "
                             "masks give different bits")
    kw = {}
    for i, n in enumerate(names):
        for mode in ("off", "input", "prng"):
            kw[f"{n}_{mode}_ms"] = f"{ms[mode][i]:.4f}"
        kw[f"{n}_mask_ms"] = f"{ms['prng'][i] - ms['off'][i]:.4f}"
    say(phase, mask_cost=arm, **kw, prng_equals_input=same)
    return ms


def mask_cost_njode(phase, arm, cfg, leaves, arrays, h0, reps):
    """The masks' cost inside K1 and K2 (``_mask_cost``) on these
    inputs, in the rule's plan."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    K, B = arrays[2].shape
    sp, si = fs.Spec(cfg, "prng"), fs.Spec(cfg, "input")
    seed = torch.tensor([20261017], dtype=torch.int64, device=h0.device)
    u = fs.philox_masks_cuda(seed, K, sp.S, B, sp.w_max, sp.thresh)
    dloss = torch.ones((), device=h0.device)
    runs = {}
    for mode, spec, train, uu, ss in (("off", sp, False, None, None),
                                      ("input", si, True, u, None),
                                      ("prng", sp, True, None, seed)):
        hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, train, uu,
                                 ss)[1]

        def fwd(spec=spec, train=train, uu=uu, ss=ss):
            return fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, train, uu,
                                    ss)

        def bwd(spec=spec, train=train, uu=uu, ss=ss, hists=hists):
            g, d = fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, train, hists,
                                    dloss, uu, ss)
            return (*g, d)

        runs[mode] = (fwd, bwd)
    return _mask_cost(phase, f"{arm} B={B} K={K} R={sp.rows_for(B, False)}",
                      ("K1", "K2"), runs, reps)


def mask_cost_gob(phase, arm, cfg, leaves, arrays, st, reps):
    """The masks' cost inside K5 and K6 (``_mask_cost``) on these
    inputs."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    K, B = arrays[2].shape
    sp, si = fg.Spec(cfg, "prng"), fg.Spec(cfg, "input")
    dev = st[0].device
    seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
    u = fg.gob_masks_cuda(seed, K, B, sp.P, sp.thresh)
    dloss = torch.ones((), device=dev)
    runs = {}
    for mode, spec, train, uu, ss in (("off", sp, False, None, None),
                                      ("input", si, True, u, None),
                                      ("prng", sp, True, None, seed)):
        hists = fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, train, uu,
                                     ss)[1]

        def fwd(spec=spec, train=train, uu=uu, ss=ss):
            return fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, train,
                                        uu, ss)

        def bwd(spec=spec, train=train, uu=uu, ss=ss, hists=hists):
            g = fg.gob_scan_bwd_cuda(spec, leaves, arrays, train, hists,
                                     dloss, uu, ss)
            return (*g[0], *g[1:])

        runs[mode] = (fwd, bwd)
    return _mask_cost(phase, f"{arm} B={B} K={K} R={sp.rows_for(B)}",
                      ("K5", "K6"), runs, reps)


def device_ms(fn, name, reps=50, tries=3):
    """Device time per call of ``fn`` of the kernels whose name holds
    ``name`` (every kernel ``fn`` launches where ``name`` is None), from
    ``torch.profiler``'s ``key_averages()`` over ``reps`` calls (one
    warm-up first); a fresh profiler up to ``tries`` times, since CUPTI
    now and then delivers no record of a run; None if none recorded it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if (ev.device_type == DeviceType.CUDA if name is None
                    else name in ev.key):
                total += (getattr(ev, "device_time_total", 0.0)
                          or getattr(ev, "cuda_time_total", 0.0))
        if total > 0:
            return total / 1e3 / reps
    return None


def queued_ms(fn, reps=50):
    """Device ms per call of ``fn`` from CUDA events, its ``reps`` calls
    queued behind a ``torch.cuda._sleep`` that outlasts their host launch
    time, so the events bracket back-to-back device work only."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)  # >= 2x at <= 2 GHz
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def kernel_ms(fn, name, reps=50):
    """:func:`device_ms` of the one kernel that ``fn`` launches, or where
    the profiler recorded none, :func:`queued_ms` (said on a line)."""
    ms = device_ms(fn, name, reps)
    if ms is None:
        ms = queued_ms(fn, reps)
        say("profiler", kernel=name or "all", recorded="none",
            timed_by="queued_cuda_events", ms=f"{ms:.5f}")
    return ms


def reduce_times(parts):
    """reduce_partials at each ``[n_parts, n]`` of ``parts``: its device
    time per launch and ``sum(dim=0)``'s (the library call), both by
    :func:`kernel_ms`, beside the old yardstick, CUDA
    events around a Python loop of wrapper calls (host time included),
    and the plain version's time; printed and returned by shape."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    out = {}
    for (n_parts, n), P in parts.items():
        dev_ms = kernel_ms(lambda: fs.reduce_partials_cuda(P),
                           "reduce_partials_kernel")
        lib_ms = kernel_ms(lambda: P.sum(dim=0), "reduce_kernel")
        r = dict(device_ms=dev_ms, library_device_ms=lib_ms,
                 host_loop_ms=cuda_ms(lambda: fs.reduce_partials_cuda(P),
                                      200),
                 library_host_loop_ms=cuda_ms(lambda: P.sum(dim=0), 200),
                 plain_ms=cuda_ms(lambda: fs.reduce_partials_plain(P), 20))
        bms, by = bound(float(n_parts * n), 4.0 * (n_parts + 1) * n,
                        PEAK_FP32)
        torch.cuda.synchronize()
        say("timing", kernel="reduce", shape=f"[{n_parts},{n}]",
            **{k: "none" if v is None else f"{v:.5f}" for k, v in r.items()},
            bound_ms=f"{bms:.5f}", bound_by=by)
        out[(n_parts, n)] = r
    return out


def _synthetic_run(tmp, phase, **kw):
    """One ``trainer.train`` run (2 epochs of batch 100, 'prng' masks) on
    the dataset under ``tmp``, with every count set to 0 just before and
    read just after; checks the metric CSV and returns the counts."""
    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import trainer
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    models = os.path.join(tmp, "models_" + phase)
    fs.reset_launch_counts()
    trainer.train(epochs=2, batch_size=100, dropout_rate=0.1,
                  dataset="BlackScholes", plot=False, evaluate=True,
                  pallas_mask_mode="prng",
                  base_data_path=os.path.join(tmp, "data"),
                  saved_models_path=models, **kw)
    torch.cuda.synchronize()
    counts = dict(fs.LAUNCHES)
    cols, rows = read_frame(os.path.join(models, "id-1", "metric_id-1.csv"))
    for row in rows:
        rec = dict(zip(cols, row))
        vals = {k: to_float(rec[k]) for k in (
            "train_loss", "eval_loss", "optimal_eval_loss",
            "evaluation_mean_diff", "train_time", "eval_time")}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite {phase} metrics: {rec}")
        say(phase, epoch=rec["epoch"],
            **{k: f"{v:.6f}" for k, v in vals.items()})
    if len(rows) != 2:
        raise AssertionError(f"expected 2 metric rows, got {len(rows)}")
    return counts


def same_as_per_epoch(phase, ref_dir, run_dir):
    """A chunked run (``epoch_chunk``) against the per-epoch run of the
    same dataset and seed: every metric of every row but the times, and
    every tensor of both checkpoint slots (model and optimizer state),
    epoch and weight. Prints whether all are equal bit for bit; fails if
    any differs beyond rtol 1e-6 / atol 1e-7."""
    import numpy as np
    import torch

    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    def rows(d):
        cols, rs = read_frame(os.path.join(d, "id-1", "metric_id-1.csv"))
        keep = [i for i, c in enumerate(cols)
                if c not in ("train_time", "eval_time")]
        return [cols[i] for i in keep], np.array(
            [[to_float(r[i]) for i in keep] for r in rs])

    def leaves(obj, path=""):
        if isinstance(obj, torch.Tensor):
            yield path, obj
        elif isinstance(obj, dict):
            for k in sorted(obj, key=str):
                yield from leaves(obj[k], f"{path}.{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, obj

    (c_ref, m_ref), (c_run, m_run) = rows(ref_dir), rows(run_dir)
    if c_ref != c_run or m_ref.shape != m_run.shape:
        raise AssertionError(f"{phase}: metric columns or rows differ: "
                             f"{c_ref} {m_ref.shape} / {c_run} "
                             f"{m_run.shape}")
    bitwise = bool(np.array_equal(m_ref, m_run, equal_nan=True))
    worst = float(np.nanmax(np.abs(m_ref - m_run) / (1e-7 + 1e-6 * np.abs(
        m_ref)))) if m_ref.size else 0.0
    for slot in ("last_checkpoint", "best_checkpoint"):
        a, b = (torch.load(os.path.join(d, "id-1", slot, "checkpt.tar"),
                           map_location="cpu", weights_only=True)
                for d in (ref_dir, run_dir))
        la, lb = list(leaves(a)), list(leaves(b))
        if [k for k, _ in la] != [k for k, _ in lb]:
            raise AssertionError(f"{phase}: {slot} keys differ")
        for (k, x), (_, y) in zip(la, lb):
            if not isinstance(x, torch.Tensor):
                if x != y:
                    raise AssertionError(f"{phase}: {slot}{k}: {x} != {y}")
                continue
            bitwise = bitwise and torch.equal(x, y)
            d = ((x.double() - y.double()).abs()
                 / (1e-7 + 1e-6 * y.double().abs()))
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
    say(phase, same_as_per_epoch=f"bitwise={bitwise}",
        tolerance_used=f"{worst:.3e}")
    if worst > 1.0:
        raise AssertionError(f"{phase}: the chunked run differs from the "
                             f"per-epoch run beyond rtol 1e-6 / atol 1e-7 "
                             f"({worst:.3e} of it)")
    return bitwise


def _check_counts(phase, counts, expect):
    """Each count exactly as expected (0 where ``expect`` has no key)."""
    for k, v in counts.items():
        want = expect.get(k, 0)
        if v != want:
            raise AssertionError(f"{phase}: launch count {k}={v}, expected "
                                 f"{want}: {counts}")
    say(phase, launches=json.dumps({k: v for k, v in counts.items() if v})
        .replace(" ", ""))


def check_rows(phase, cfg):
    """Every K1-K3 launch of the run just made (``LAUNCH_ROWS``, set to 0
    with the counts) took the rows ``Spec(cfg).rows_for`` takes at its
    batch; prints them."""
    from njode_tpu_torch.ops import fused_scan as fs

    spec = fs.Spec(cfg)
    seen = {}
    for (key, B, R), n in sorted(fs.LAUNCH_ROWS.items()):
        want = spec.rows_for(B, "bwd" in key)
        if R != want:
            raise AssertionError(f"{phase}: {key} at B={B} took {R} rows, "
                                 f"the rule takes {want}")
        seen[f"{key}@{B}"] = f"R{R}x{n}"
    if not seen:
        raise AssertionError(f"{phase}: no scan kernel launched")
    say(phase, rows=json.dumps(seen).replace(" ", ""))


def check_waves(phase, arm, cfg, B):
    """K1, K3 and K2 of ``cfg`` at batch B at the rows the rule takes: the
    CTAs an SM holds that the rule counts (``Spec.ctas_per_sm``; the
    global plan: one) against cudaOccupancyMaxActiveBlocksPerMultiprocessor
    for the kernel the launch takes. Fails if the card holds fewer, or if a
    launch the rule puts on one wave would take a second."""
    import ctypes

    from njode_tpu_torch.ops import fused_scan as fs

    spec = fs.Spec(cfg)
    lib = fs._lib()
    out = {}
    for name, kind, bwd, train in (("K1", 0, False, True),
                                   ("K3", 1, False, False),
                                   ("K2", 2, True, True)):
        c = fs.make_cfg(spec, 100, B, train, 0.5, bwd=bwd)
        n = ctypes.c_int(0)
        fs._raise_rc(lib, lib.njode_scan_occupancy(
            ctypes.addressof(c), kind, ctypes.byref(n)),
            "njode_scan_occupancy")
        n_cta = -(-B // c.rows)
        rule = (spec.ctas_per_sm(c.rows, bwd) if spec.plan == "resident"
                else 1)
        one_wave = n_cta <= rule * fs.N_SM
        if n.value < rule or (one_wave and n_cta > n.value * fs.N_SM):
            raise AssertionError(
                f"{arm} {name} at B={B}, {c.rows} rows: the rule counts "
                f"{rule} CTAs an SM, the card holds {n.value}")
        out[name] = dict(rows=c.rows, ctas=n_cta, rule_per_sm=rule,
                         card_per_sm=n.value, one_wave=one_wave)
    say(phase, arm=arm, B=B, waves=json.dumps(out).replace(" ", ""))


def phase_trainer(results):
    """The main path, then the same trainer with the GRU jump
    (``use_rnn``) on the same dataset, each with exact launch counts."""
    from njode_tpu_torch.data import datasets

    tmp = tempfile.mkdtemp(prefix="njode_smoke_")
    try:
        hp = dict(datasets.hyperparam_default, nb_paths=20_000,
                  obs_perc=0.1)
        t0 = time.time()
        datasets.create_dataset("BlackScholes", hp, seed=0,
                                base_path=os.path.join(tmp, "data"))
        say("trainer", dataset_s=f"{time.time() - t0:.2f}", paths=20000)
        steps = 2 * (16_000 // 100)
        expect = {"njode_scan_fwd": steps, "njode_scan_bwd": steps,
                  "njode_scan_eval": 2, "philox_keep": 2 * steps,
                  "reduce_partials": 2 * steps + 2}
        counts = _synthetic_run(tmp, "trainer")
        _check_counts("trainer", counts, expect)
        check_rows("trainer", results["setup"]["cfg"])
        results["launches"] = counts
        # the same run in one chunk of 2 epochs (train_epochs)
        t0 = time.time()
        chunk = _synthetic_run(tmp, "chunk", epoch_chunk=2)
        _check_counts("chunk", chunk, expect)
        check_rows("chunk", results["setup"]["cfg"])
        same_as_per_epoch("chunk", os.path.join(tmp, "models_trainer"),
                          os.path.join(tmp, "models_chunk"))
        say("chunk", phase_s=f"{time.time() - t0:.2f}")
        results["chunk_launches"] = chunk
        t0 = time.time()
        rnn = _synthetic_run(tmp, "rnn_trainer", use_rnn=True)
        _check_counts("rnn_trainer", rnn, {
            "njode_scan_fwd_rnn": steps, "njode_scan_bwd_rnn": steps,
            "njode_scan_eval_rnn": 2, "philox_keep": 2 * steps,
            "reduce_partials": 2 * steps + 2})
        check_rows("rnn_trainer", dataclasses.replace(
            results["setup"]["cfg"], use_rnn=True))
        say("rnn_trainer", phase_s=f"{time.time() - t0:.2f}")
        results["rnn_launches"] = rnn
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


def gob_wide_setup(D, width, B, K, seed, device):
    """A GRU-ODE-Bayes model of D inputs with every width ``width`` (full
    field, impute, logvar, mixing 1e-4, dropout 0.1) and a random batch
    (lognormal paths, 10 % of the steps observed, 70 % of an observed
    row's coordinates) on the card; returns what gob_setup returns."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    cfg = gob.GOBConfig(input_size=D, hidden_size=width, p_hidden=width,
                        prep_hidden=width, cov_size=D, cov_hidden=width,
                        logvar=True, mixing=1e-4, dropout_rate=0.1,
                        full_gru_ode=True, impute=True)
    model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0.0, 0.3, size=(B, D, K + 1))
    observed = (rs.random((B, K + 1)) < 0.1).astype(np.int64)
    b = grid.recompute_n_obs(grid.batch_from_paths(paths, observed, 1.0 / K))
    M = (rs.random(b.M.shape) < 0.7).astype(np.float32) * b.obs[:, :, None]
    b = b._replace(X=(b.X * M).astype(np.float32), M=M)
    batch = grid.to_torch(b, device)
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.M)
    leaves = [p.detach() for p in fg.flat_leaves(model, fg.Spec(cfg))]
    with torch.no_grad():
        h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
        p0 = gob.mlp2(model.p_model, h0, 0.0)
    return cfg, model, batch, arrays, leaves, (
        h0.contiguous(), p0[:, :D].contiguous(), p0[:, D:].contiguous())


def _gob_masks(spec, mode, K, B, gen, dev):
    import torch
    if mode == "input":
        return (torch.rand((K, 3, B, spec.P), generator=gen,
                           device=dev) < 0.9).to(torch.int8), None
    return None, torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev,
                               dtype=torch.int64)


def _gob_pair(spec, leaves, arrays, st, u, seed, tag):
    """K5 and K6 twice bit for bit and against their plain versions;
    returns the errors (loss, histories, gradients, d(h0, m0, v0))."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    runs = [fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, True, u, seed)
            for _ in range(2)]
    (lk, hk), (lk2, hk2) = runs
    torch.cuda.synchronize()
    if not (torch.equal(lk, lk2) and all(
            torch.equal(a, b) for a, b in zip(hk, hk2))):
        raise AssertionError(f"K5 ({tag}) differs between runs")
    lp, hp = fg.gob_scan_fwd_plain(spec, leaves, arrays, *st, True, u, seed)
    e = {"loss": check_close(f"K5 loss ({tag})", lk, lp, LOSS_TOL),
         "loss_val": float(lk)}
    e["hist"] = max(check_close(f"K5 {n} ({tag})", a, b, scaled_tol(b))
                    for n, a, b in zip("hmv", hk, hp))
    dloss = torch.ones((), device=lk.device)
    outs = [fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                                 seed) for _ in range(2)]
    torch.cuda.synchronize()
    (gk, *dk), (gk2, *dk2) = outs
    if not all(torch.equal(a, b) for a, b in
               zip(list(gk) + dk, list(gk2) + dk2)):
        raise AssertionError(f"K6 ({tag}) differs between runs")
    gp, *dp = fg.gob_scan_bwd_plain(spec, leaves, arrays, True, hk, dloss, u,
                                    seed)
    tol = scaled_tol(torch.cat([g.reshape(-1) for g in gp]))
    e["grad"] = max(check_close(f"K6 grad {i} ({tag})", a, b, tol)
                    for i, (a, b) in enumerate(zip(gk, gp)))
    e["d0"] = max(check_close(f"K6 {n} ({tag})", a, b, scaled_tol(b))
                  for n, a, b in zip(("dh0", "dm0", "dv0"), dk, dp))
    e["max_grad"] = float(tol["atol"]) / 2e-5
    return e


def _say_pair(tag_kw, e):
    say("gob_kernels", **tag_kw, K5_loss_err=f"{e['loss']:.3e}",
        K5_hist_err=f"{e['hist']:.3e}", K6_grad_err=f"{e['grad']:.3e}",
        K6_d0_err=f"{e['d0']:.3e}", loss=f"{e['loss_val']:.6f}",
        max_grad=f"{e['max_grad']:.3e}", bitwise_repeat=True)


def phase_gob_kernels(results):
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    dev = torch.device("cuda")
    B, K = 20, 100
    errs = {"K5": 0.0, "K6": 0.0}
    gen = torch.Generator(device=dev).manual_seed(5)

    def check(cfg, leaves, st, arrays, mode, rows, **tag):
        spec = fg.Spec(cfg, mode, rows=rows)
        u, seed = _gob_masks(spec, mode, K, B, gen, dev)
        R = spec.rows_for(B)
        e = _gob_pair(spec, leaves, arrays, st, u, seed,
                      " ".join(f"{k}={v}" for k, v in tag.items())
                      + f" {mode} R={R}")
        errs["K5"] = max(errs["K5"], e["loss"])
        errs["K6"] = max(errs["K6"], e["grad"], e["d0"])
        _say_pair(dict(tag, mode=mode, R=R), e)

    # the published widths at the rule's rows (one a CTA at B = 20)
    for hidden in (50, 100):
        for impute, mixing in ((True, 1e-4), (False, 1e-4), (True, 0.5),
                               (False, 0.5)):
            cfg, _, _, arrays, leaves, st = gob_setup(
                B, K, hidden, impute, mixing, hidden, dev)
            for mode in ("input", "prng"):
                check(cfg, leaves, st, arrays, mode, None, H=hidden,
                      impute=impute, mixing=mixing)
    # forced rows: 8 at hidden 50, and at hidden 100 the most that fit (4)
    for hidden, R in ((50, 8), (100, 4)):
        cfg, _, _, arrays, leaves, st = gob_setup(B, K, hidden, True, 1e-4,
                                                  hidden, dev)
        for mode in ("input", "prng"):
            check(cfg, leaves, st, arrays, mode, R, H=hidden, impute=True,
                  mixing=1e-4, forced=True)
    # the widths 8 rows a CTA could not hold: D = 1 at widths 200, D = 41
    # at widths 50
    for D, width in ((1, 200), (41, 50)):
        cfg, _, _, arrays, leaves, st = gob_wide_setup(D, width, B, K, 11,
                                                       dev)
        if not fg.supported(cfg):
            raise AssertionError(f"D={D} width={width} is not supported")
        for mode in ("input", "prng"):
            check(cfg, leaves, st, arrays, mode, None, D=D, width=width)
    # K6's stages against their plain version at the trainer's widths:
    # stage (a)'s saved buffers and stage (b)'s deltas in the workspace,
    # buffer by buffer, and stage (c)'s gradients
    cfg, _, _, arrays, leaves, st = gob_setup(B, K, 50, True, 1e-4, 50, dev)
    spec = fg.Spec(cfg, "prng")
    _, seed = _gob_masks(spec, "prng", K, B, gen, dev)
    _, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, True, None, seed)
    dloss = torch.ones((), device=dev)
    got = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, None,
                               seed, chunk=K, want_ws=True)
    ref = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hk, dloss,
                                       None, seed, chunk=K, want_ws=True)
    torch.cuda.synchronize()

    def ws_err(names, what):
        return max(check_close(f"K6 {what} {n}",
                               fg.ws_view(spec, got[4], K * B, n),
                               fg.ws_view(spec, ref[4], K * B, n),
                               scaled_tol(fg.ws_view(spec, ref[4], K * B, n)))
                   for n in names)

    errs["remat"] = ws_err(fg.SAVED, "stage (a)")
    errs["chain"] = ws_err([d for d, _ in spec.deltas], "stage (b)")
    tol = scaled_tol(torch.cat([g.reshape(-1) for g in ref[0]]))
    errs["wgrad"] = max(check_close(f"K6 stage (c) grad {i}", a, b, tol)
                        for i, (a, b) in enumerate(zip(got[0], ref[0])))
    say("gob_kernels", stages="remat,chain,wgrad",
        remat_err=f"{errs['remat']:.3e}", chain_err=f"{errs['chain']:.3e}",
        wgrad_err=f"{errs['wgrad']:.3e}", n_ws=spec.n_ws,
        deltas=len(spec.deltas))
    results["gob_stage"] = (spec, leaves, arrays, hk, seed, got[4])
    # K7 directly: the kernels' Philox slots 0-2 against the plain Philox
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
    say("gob_kernels", K5_eval_B=Be, K5_eval_R=spec_e.rows_for(Be, False),
        K5_eval_err=f"{e_ev:.3e}", K5_eval_loss=f"{float(le[0]):.6f}")
    results["gob_errs"] = dict(errs, K5e=e_ev, K7=float(n_bad))
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


def gob_bounds(spec, K, B, train=True):
    """(flop, bytes) of K5 (train or eval form) and K6 at these shapes,
    the same whatever implements them: the flops from the MACs per
    row-step (backward 3x the forward), the bytes with each input read
    once (weights, times, dts, obs, X, M, the t=0 state or the histories,
    the seed, dloss) and each output written once (the loss; the
    histories; every gradient and d(h0, m0, v0))."""
    mac = gob_macs_per_row_step(spec)
    f_fwd = 2.0 * mac * B * K
    D, H = spec.D, spec.H
    w = 4 * spec.n_params
    data = 4 * (2 * K + K * B + 2 * K * B * D)
    hists = 4 * K * B * (H + 2 * D)
    state = 4 * B * (H + 2 * D)
    b_fwd = w + data + state + 4 + (hists + 8 if train else 0)
    b_bwd = w + data + hists + 8 + 4 + w + state
    return (f_fwd, b_fwd), (3.0 * f_fwd, b_bwd)


def gob_stage_bounds(spec, K, B):
    """(flop, bytes) of each of K6's stages at these shapes: (a) the
    forward flops, reading the weights, the step inputs and the histories
    and writing the saved buffers; (b) the transposed products (twice the
    forward's flops), reading the saved buffers and writing the deltas
    and d(h0, m0, v0); (c) 2 in out per (step, row) for every job of
    ``wgrad_jobs``, reading each buffer it names once and writing every
    gradient."""
    from njode_tpu_torch.ops import fused_gob as fg

    f = 2.0 * gob_macs_per_row_step(spec) * B * K
    D, H, KB = spec.D, spec.H, K * B
    w = 4 * spec.n_params
    saved = sum(spec.width(n) for n in fg.SAVED)
    deltas = spec.n_ws - saved
    data = 4 * (2 * K + KB + 2 * KB * D)
    hists = 4 * KB * (H + 2 * D)
    jobs = spec.wgrad_jobs()
    f_c = sum(2.0 * KB * spec.leaf_shapes[lf][0] * spec.leaf_shapes[lf][1]
              for lf, _, _ in jobs)
    read = {n for _, x, d in jobs for n in (x, d) if n is not None}
    return {"remat": (f, w + data + hists + 8 + 4 * KB * saved),
            "chain": (2.0 * f, w + 4 * K + 4 * KB * (saved + deltas) + 8
                      + 4 * B * (H + 2 * D)),
            "wgrad": (f_c, 4 * KB * sum(spec.width(n) for n in read) + w)}


def bound(flops, nbytes, peak):
    tf, tb = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def _staged_plain_ms(spec, leaves, arrays, hists, seed):
    """CUDA-event ms of the plain version of each of K6's stages over one
    chunk of all K steps ('prng' masks): (a) every step's saved buffers,
    (b) the reverse chain, (c) the products of ``wgrad_jobs`` (the code of
    ``fused_gob.gob_scan_bwd_staged_plain``, stage by stage)."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    times, dts, obs, X, M = arrays
    hh, mh, vh = hists
    K, B = obs.shape
    w = spec.weights(list(leaves))
    s_i = int(seed)
    dt = [float(x) for x in dts]
    masks = [fg._step_masks_plain(spec, k, True, None, s_i, B, hh.device)
             for k in range(K)]
    with torch.no_grad():
        saved, ms_a = timed(lambda: [fg._step_bufs_plain(
            spec, w, hh[k], mh[k], vh[k], dt[k], obs[k], X[k], M[k],
            masks[k]) for k in range(K)])

        def chain():
            dh, dm, dv = (torch.zeros_like(x[0]) for x in hists)
            out = [None] * K
            for k in reversed(range(K)):
                dh, dm, dv, out[k] = fg._chain_step_plain(
                    spec, w, saved[k], dh, dm, dv, dt[k], 1.0, masks[k])
            return out

        dl, ms_b = timed(chain)
        cat = {n: torch.cat([saved[k][n] for k in range(K)])
               for n in fg.SAVED}
        cat.update({n: torch.cat([dl[k][n] for k in range(K)])
                    for n, _ in spec.deltas})
        _, ms_c = timed(lambda: [
            cat[d].sum(0) if x is None else cat[x].t() @ cat[d]
            for _, x, d in spec.wgrad_jobs()])
    return {"remat": ms_a, "chain": ms_b, "wgrad": ms_c}


def _wgrad_library(spec, ws, KB):
    """Stage (c)'s jobs as PyTorch calls on the kernel's own workspace
    (torch.matmul of each x^T d, sum for a bias): the yardstick of
    gob_wgrad_kernel, used nowhere in the port."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    out = []
    for _, x, d in spec.wgrad_jobs():
        dm = fg.ws_view(spec, ws, KB, d)
        out.append(dm.sum(0) if x is None
                   else torch.matmul(fg.ws_view(spec, ws, KB, x).t(), dm))
    return out


def stage_device_ms(fn, reps):
    """Device ms per K6 call of each stage's kernel (torch.profiler, each
    up to three tries); the run fails if the profiler records none, as
    one C call launches all three and no event can part them."""
    out = {n: device_ms(fn, f"gob_{n}_kernel", reps)
           for n in ("remat", "chain", "wgrad")}
    if any(v is None for v in out.values()):
        raise AssertionError(f"torch.profiler recorded no K6 stage: {out}")
    return out


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
        stages = stage_device_ms(bwd, 5)
        (f5, b5), (f6, b6) = gob_bounds(spec, K, B)
        sb = gob_stage_bounds(spec, K, B)
        say("gob_timing", kernel="K5", H=hidden, B=B, R=spec.rows_for(B),
            ms=f"{k5:.4f}", bound_ms=f"{bound(f5, b5, PEAK_FP32)[0]:.5f}")
        say("gob_timing", kernel="K6", H=hidden, B=B, R=spec.rows_for(B),
            ms=f"{k6:.4f}", bound_ms=f"{bound(f6, b6, PEAK_FP32)[0]:.5f}",
            **{f"{n}_device_ms": f"{v:.4f}" for n, v in stages.items()},
            chunks=-(-K // spec.bwd_chunk(K, B)))
        if hidden == 50:                 # the trainer's configuration
            t["K5"] = (k5, cuda_ms(lambda: fg.gob_scan_fwd_plain(
                spec, leaves, arrays, *st, True, None, seed), 2, 1))
            t["K6"] = (k6, cuda_ms(lambda: fg.gob_scan_bwd_plain(
                spec, leaves, arrays, True, hists, dloss, None, seed), 1, 1))
            bnd["K5"] = bound(f5, b5, PEAK_FP32)
            bnd["K6"] = bound(f6, b6, PEAK_FP32)
            plain = _staged_plain_ms(spec, leaves, arrays, hists, seed)
            ws = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hists,
                                      dloss, None, seed, want_ws=True)[4]
            # the yardstick's device time, like the stages': the kernels
            # of one pass over the jobs, host launches left out
            lib = kernel_ms(lambda: _wgrad_library(spec, ws, K * B), None,
                            reps=5)
            for n in ("remat", "chain", "wgrad"):
                t["K6" + n] = (stages[n], plain[n])
                bnd["K6" + n] = bound(*sb[n], PEAK_FP32)
            results["library_ms"]["K6wgrad"] = lib
            karange = torch.arange(K, device=dev)
            t["K7"] = (mask_kernel_ms(
                "gob_timing", "gob_masks_kernel",
                lambda: fg.gob_masks_cuda(seed, K, B, spec.P, spec.thresh),
                f"[{K},3,{B},{spec.P}]"),
                cuda_ms(lambda: fg.gob_masks_plain(
                    int(seed), karange, B, spec.P, spec.thresh, dev), 3, 1))
            n_mask = K * 3 * B * spec.P
            bnd["K7"] = bound(n_mask * (98.0 / 4 + 1), n_mask + 8,
                              PEAK_INT32)
            # the climate GOB arm's shape: the masks of its 2,004 steps
            Kc, Bc, Pc = 2004, 100, 25
            ms_c = mask_kernel_ms(
                "gob_timing", "gob_masks_kernel",
                lambda: fg.gob_masks_cuda(seed, Kc, Bc, Pc, spec.thresh),
                f"[{Kc},3,{Bc},{Pc}]")
            n_c = Kc * 3 * Bc * Pc
            bms_c, by_c = bound(n_c * (98.0 / 4 + 1), n_c + 8, PEAK_INT32)
            say("gob_timing", kernel="K7", shape=f"[{Kc},3,{Bc},{Pc}]",
                device_ms=f"{ms_c:.5f}", bound_ms=f"{bms_c:.6f}",
                bound_by=by_c, roofline_share=f"{bms_c / ms_c:.2e}")
            mask_cost_gob("gob_timing", "gob_h50", cfg, leaves, arrays, st,
                          10)
    spec_e, arrays_e, leaves_e, st_e = results["gob_eval"]
    Ke, Be = arrays_e[2].shape
    ev = lambda: fg.gob_scan_fwd_cuda(spec_e, leaves_e, arrays_e,  # noqa
                                      *st_e, False, want_hists=False)
    t["K5e"] = (cuda_ms(ev, 5), cuda_ms(lambda: fg.gob_scan_fwd_plain(
        spec_e, leaves_e, arrays_e, *st_e, False, want_hists=False), 1, 1))
    (fe, be), _ = gob_bounds(spec_e, Ke, Be, train=False)
    bnd["K5e"] = bound(fe, be, PEAK_FP32)
    results["times"].update(t)
    results["bounds"].update(bnd)
    for k in ("K5", "K5e", "K6", "K6remat", "K6chain", "K6wgrad", "K7"):
        ms, plain = t[k]
        bms, by = bnd[k]
        lib = results["library_ms"].get(k)
        say("gob_timing", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bms:.6f}", bound_by=by,
            roofline_share=f"{bms / ms:.2e}",
            library_ms="none" if lib is None else f"{lib:.4f}")


GOB_TRAIN_SIZE = 8000      # all 8,000 training paths: 400 steps an epoch


class BwdChunks:
    """While a trainer runs, records for each K6 call the chunks of steps
    its shapes take (``Spec.bwd_chunk``), each a launch of every stage,
    so that the run's launch counts can be checked exactly; the wrapper
    itself runs as it is."""

    def __enter__(self):
        from njode_tpu_torch.ops import fused_gob as fg

        self.fg, self.orig, self.chunks = fg, fg.gob_scan_bwd_cuda, []

        def recorded(spec, leaves, arrays, train, hists, dloss, u=None,
                     seed=None, chunk=None, want_ws=False):
            K, B = arrays[2].shape
            self.chunks.append(-(-K // (chunk or spec.bwd_chunk(K, B))))
            return self.orig(spec, leaves, arrays, train, hists, dloss, u,
                             seed, chunk, want_ws)

        fg.gob_scan_bwd_cuda = recorded
        return self

    def __exit__(self, *exc):
        self.fg.gob_scan_bwd_cuda = self.orig

    def expect(self, steps, evals=0, reduce_extra=0):
        """The exact counts of ``steps`` training steps: K5 each, the
        three stages per chunk, and the mask words K5 and stage (a) fill
        ('gob_philox_keep'; stage (b) draws none)."""
        if len(self.chunks) != steps:
            raise AssertionError(f"{len(self.chunks)} K6 calls, expected "
                                 f"{steps}")
        n = sum(self.chunks)
        return {"gob_scan_fwd": steps, "gob_bwd_remat": n,
                "gob_scan_bwd": n, "gob_bwd_wgrad": n, "gob_scan_eval": evals,
                "gob_philox_keep": steps + n,
                "reduce_partials": 2 * steps + reduce_extra}


def _gob_run(tmp, phase, **kw):
    """One GOB ``trainer.train`` run (2 epochs, the published widths) on
    the dataset under ``tmp``, with every count set to 0 just before and
    read just after; checks the metric CSV and the launch counts (exactly
    what 2 epochs need) and returns the counts."""
    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import trainer
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    models = os.path.join(tmp, "models_" + phase)
    fs.reset_launch_counts()
    fg.reset_launch_counts()
    chunks = BwdChunks()
    with chunks:
        trainer.train(epochs=2, batch_size=20, hidden_size=50,
                      dropout_rate=0.1, dataset="BlackScholes",
                      plot=False, evaluate=True,
                      other_model="GRU_ODE_Bayes",
                      training_size=GOB_TRAIN_SIZE,
                      base_data_path=os.path.join(tmp, "data"),
                      saved_models_path=models,
                      **{"GRU_ODE_Bayes-impute": True,
                         "GRU_ODE_Bayes-logvar": True,
                         "GRU_ODE_Bayes-mixing": 1e-4}, **kw)
    torch.cuda.synchronize()
    counts = dict(fg.LAUNCHES)
    counts["reduce_partials"] = fs.LAUNCHES["reduce_partials"]
    njode_counts = {k: v for k, v in fs.LAUNCHES.items()
                    if k != "reduce_partials"}
    cols, rows = read_frame(os.path.join(models, "id-1", "metric_id-1.csv"))
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
        say(phase, epoch=rec["epoch"],
            **{k: f"{v:.6f}" for k, v in vals.items()})
    if len(rows) != 2:
        raise AssertionError(f"expected 2 metric rows, got {len(rows)}")
    steps = 2 * (GOB_TRAIN_SIZE // 20)
    expect = chunks.expect(steps, evals=2, reduce_extra=2)
    expect["gob_masks"] = 0
    for k, v in expect.items():
        if counts[k] != v:
            raise AssertionError(f"launch count {k}={counts[k]}, "
                                 f"expected {v}: {counts}")
    if any(njode_counts.values()):
        raise AssertionError(f"NJODE kernels ran in the GOB path: "
                             f"{njode_counts}")
    say(phase, launches=json.dumps(counts).replace(" ", ""))
    return counts


def phase_gob_trainer(results):
    """The GOB trainer per epoch, then (gob_chunk) in one chunk of 2
    epochs (train_epochs) on the same dataset and seed, held against it."""
    from njode_tpu_torch.data import datasets

    tmp = tempfile.mkdtemp(prefix="njode_smoke_gob_")
    try:
        hp = dict(datasets.hyperparam_default, obs_perc=0.1)
        t0 = time.time()
        datasets.create_dataset("BlackScholes", hp, seed=0,
                                base_path=os.path.join(tmp, "data"))
        say("gob_trainer", dataset_s=f"{time.time() - t0:.2f}",
            paths=hp["nb_paths"], training_size=GOB_TRAIN_SIZE)
        results["gob_launches"] = _gob_run(tmp, "gob_trainer")
        t0 = time.time()
        results["gob_chunk_launches"] = _gob_run(tmp, "gob_chunk",
                                                 epoch_chunk=2)
        same_as_per_epoch("gob_chunk",
                          os.path.join(tmp, "models_gob_trainer"),
                          os.path.join(tmp, "models_gob_chunk"))
        say("gob_chunk", phase_s=f"{time.time() - t0:.2f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synthetic_setup(kind, N, K, seed=0):
    """Step functions through the kernels for a model at a trainer's
    widths on the card (``kind`` 'njode': the bench's and main path's;
    'gob': the GOB trainer's, hidden 50, impute, logvar, mixing 1e-4,
    dropout 0.1), with N of the bench's paths and observations on the
    card; returns (fns, paths, obs)."""
    import numpy as np
    import torch

    from njode_tpu_torch import bench
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.training.steps import make_optimizer, make_step_fns

    dev = torch.device("cuda")
    dt = 1.0 / K
    paths = torch.as_tensor(bench.simulate_bs_paths(N, K, dt), device=dev)
    obs = torch.as_tensor((np.random.RandomState(1).random((N, K + 1))
                           < 0.1).astype(np.float32), device=dev)
    times = torch.as_tensor((np.arange(1, K + 1) * dt).astype(np.float32),
                            device=dev)
    dts = torch.full((K,), dt, dtype=torch.float32, device=dev)
    if kind == "gob":
        cfg = gob.GOBConfig(input_size=1, hidden_size=50, p_hidden=50,
                            prep_hidden=50, cov_size=1, cov_hidden=50,
                            logvar=True, mixing=1e-4, dropout_rate=0.1,
                            full_gru_ode=True, impute=True)
        model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
        make = gob.make_step_fns
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = njode.NJODE(bench.bench_config())
        make = make_step_fns
    model.to(dev)
    fns = make(model, make_optimizer(model.parameters(), 1e-3), times, dts,
               use_kernels=True)
    return fns, paths, obs


def epochs_args(paths, obs, B, n_ep, seed, n_val=8):
    """The arguments of a ``train_epochs`` call of ``n_ep`` epochs over
    every path at batch B (validation: the first ``n_val`` paths, no
    oracle difference), made on the card before the call."""
    import numpy as np
    import torch

    N = paths.shape[0]
    mats = torch.as_tensor(np.stack([
        np.random.RandomState(seed + j).permutation(N).reshape(N // B, B)
        for j in range(n_ep)]), device=paths.device)
    gens = [torch.Generator(device=paths.device).manual_seed(seed + j)
            for j in range(n_ep)]
    return (paths, obs, mats, [0.5] * n_ep, gens, paths, obs,
            torch.arange(n_val, device=paths.device), False)


def sync_free(phase, arm, call):
    """Runs ``call`` under ``torch.cuda.set_sync_debug_mode("error")``:
    any operation that makes the host wait for the card (a read back, a
    synchronous copy) raises. Prints whether none did and, if one did, the
    port's line that made it; returns that line or None."""
    import traceback

    import torch

    torch.cuda.synchronize()
    where = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "njode_tpu_torch" in f.filename]
        where = (f"{os.path.relpath(frames[-1].filename, ROOT)}:"
                 f"{frames[-1].lineno}" if frames
                 else str(e).splitlines()[0][:120])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(phase, arm=arm, sync_free=where is None,
        **({"first_sync": where} if where else {}))
    return where


def phase_sync(results):
    """One ``train_epochs`` call (2 epochs, no oracle difference) under
    the sync check, after a warm-up call that fills the kernels' caches:
    NJODE at the main path's widths (B = 100, K = 100, 2,000 paths) must
    make the host wait nowhere; the GOB chunk (hidden 50, B = 20, 400
    paths) is reported. A read back (``.item()``) under the same check
    must be caught, or the check proves nothing."""
    import torch

    one = torch.ones(1, device="cuda")
    if sync_free("sync", "control_item", lambda: one.item()) is None:
        raise AssertionError("the sync check let a read back through")
    for kind, N, B in (("njode", 2000, 100), ("gob", 400, 20)):
        fns, paths, obs = synthetic_setup(kind, N, 100)
        fns["train_epochs"](*epochs_args(paths, obs, B, 2, 10))
        args = epochs_args(paths, obs, B, 2, 20)
        where = sync_free("sync", kind, lambda: fns["train_epochs"](*args))
        results[f"sync_{kind}"] = where
        if kind == "njode" and where is not None:
            raise AssertionError(f"NJODE train_epochs made the host wait "
                                 f"at {where}")


def busy_share(fn):
    """``fn()`` and a synchronise under torch.profiler (CUDA activity
    only): the summed device time of every kernel and copy it recorded
    over the host time of the window; (share, device ms, wall ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sum((getattr(ev, "self_device_time_total", 0.0)
               or getattr(ev, "self_cuda_time_total", 0.0))
              for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA) / 1e3
    if dev <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return dev / wall, dev, wall


def phase_busy(results):
    """The device's busy share over one epoch queued through
    ``train_epoch`` and one ``train_epochs`` chunk: NJODE at the bench's
    shape (16,000 paths, B = 200, K = 100; a chunk of 7, the bench's), GOB
    at the trainer's widths (2,000 paths, B = 20, K = 100; a chunk of 2),
    each after a warm-up."""
    import torch

    out = {}
    for kind, N, B, CH in (("njode", 16_000, 200, 7), ("gob", 2000, 20, 2)):
        fns, paths, obs = synthetic_setup(kind, N, 100)
        perm = epochs_args(paths, obs, B, 1, 30)[2][0]

        def epoch():
            fns["train_epoch"](paths, obs, perm, 0.5, torch.Generator(
                device=paths.device).manual_seed(31))

        epoch()
        args = epochs_args(paths, obs, B, CH, 40)
        for arm, fn in (("epoch", epoch),
                        (f"chunk{CH}", lambda: fns["train_epochs"](*args))):
            share, dev, wall = busy_share(fn)
            say("busy", path=kind, arm=arm, N=N, B=B,
                busy_share=f"{share:.4f}", device_ms=f"{dev:.2f}",
                wall_ms=f"{wall:.2f}")
            out[(kind, arm)] = share
    results["busy"] = out


def phase_bench(results):
    """``njode_tpu_torch.bench.main()`` at its shape (16,000 paths, B =
    200, K = 100, ``NJODE_BENCH_REPS`` or 7 epochs each way, chunks of 7),
    its lines printed as ``[bench]`` lines, with exact launch counts: 80
    K1 and K2 an epoch (the warm-up, the timed, the queued and the chunked
    epochs), one K3 a chunked epoch."""
    import contextlib
    import io

    import torch

    from njode_tpu_torch import bench
    from njode_tpu_torch.ops import fused_scan as fs

    buf = io.StringIO()
    fs.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        out = bench.main()
    torch.cuda.synchronize()
    counts = dict(fs.LAUNCHES)
    for ln in buf.getvalue().splitlines():
        print("[bench] " + ln, flush=True)
    reps = out["per_epoch_dispatch"]["spread"]["n"]
    chunked = 4 * out["epoch_chunk"]
    steps = 80 * (1 + 2 * reps + chunked)
    _check_counts("bench", counts, {
        "njode_scan_fwd": steps, "njode_scan_bwd": steps,
        "njode_scan_eval": chunked, "philox_keep": 2 * steps,
        "reduce_partials": 2 * steps + chunked})
    times = out["per_epoch_dispatch"]["epoch_s"]
    say("bench", per_epoch_s=f"{sorted(times)[reps // 2]:.4f}",
        pipelined_epoch_s=f"{16_000 / out['pipelined_paths_per_sec']:.4f}",
        chunked_epoch_s=f"{16_000 / out['value']:.4f}")
    results["bench_launches"] = counts


def _first_steps(batch, K):
    """The first K grid steps of a GridBatch, n_obs_ot recounted."""
    b = batch._replace(times=batch.times[:K].contiguous(),
                       dt=batch.dt[:K].contiguous(),
                       obs=batch.obs[:K].contiguous(),
                       X=batch.X[:K].contiguous(), M=batch.M[:K].contiguous())
    return b._replace(n_obs_ot=b.obs.sum(dim=0))


def climate_setup(results, tmp):
    """The full-scale stand-in, its fold files, fold 0's training split
    and pre-stacked bank, and epoch 1's first training batch on the
    card."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import climate as cdu
    from njode_tpu_torch.training import climate_trainer as ct
    from njode_tpu_torch.training.steps import prestacked_batch

    dev = torch.device("cuda")
    t0 = time.time()
    csv = os.path.join(tmp, "small_chunked_sporadic.csv")
    _, rows = cdu.make_synthetic_climate_csv(csv, n_series=CLIMATE_SERIES)
    cdu.make_fold_indices(tmp, CLIMATE_SERIES)
    train_idx = np.load(os.path.join(tmp, "small_chunk_fold_idx_0",
                                     "train_idx.npy"))
    ds = cdu.ClimateDataset(csv, idx=train_idx)
    K = ds.max_grid_steps(0.1, 200.0)
    pre = cdu.prestack_series(ds, 0.1, 200.0, K)
    E = pre["k"].shape[1]
    bank = [torch.as_tensor(a, device=dev) for a in (
        np.concatenate([pre["k"], np.full((1, E), K, np.int32)]).astype(
            np.int64),
        np.concatenate([pre["X"], np.zeros((1, E, 5), np.float32)]),
        np.concatenate([pre["M"], np.zeros((1, E, 5), np.float32)]))]
    idx_mat, _, _ = ct.epoch_batches(398, 1, len(ds), CLIMATE_B)
    batch = prestacked_batch(*bank, torch.as_tensor(idx_mat[0], device=dev),
                             torch.as_tensor(pre["times"], device=dev),
                             torch.as_tensor(pre["dt"], device=dev))
    torch.cuda.synchronize()
    results["climate"] = dict(dir=tmp, n_train=len(ds), batch=batch, K=K,
                              bank=(bank, torch.as_tensor(pre["times"],
                                                          device=dev),
                                    torch.as_tensor(pre["dt"], device=dev),
                                    len(ds)))
    say("climate_setup", series=CLIMATE_SERIES, csv_rows=len(rows),
        n_train=len(ds), K=K, B=CLIMATE_B,
        batch_obs=int(batch.obs.sum()), setup_s=f"{time.time() - t0:.2f}")


def _masked_cfg(D, H, width, use_rnn=False):
    """The config of a masked NJODE (output = input) with three 2 x
    ``width`` tanh MLPs and dropout 0.1, the climate and PhysioNet arms'
    shape (with the GRU jump: ``use_rnn``)."""
    from njode_tpu_torch.models.njode import NJODEConfig

    nn_desc = ((width, "tanh"), (width, "tanh"))
    return NJODEConfig(D, H, D, nn_desc, nn_desc, nn_desc,
                       dropout_rate=0.1, masked=True, use_rnn=use_rnn)


def _masked_njode(D, H, width, dev, seed=0, use_rnn=False):
    """``_masked_cfg`` and its model on ``dev``, seeded."""
    import torch

    from njode_tpu_torch.models.njode import NJODE

    cfg = _masked_cfg(D, H, width, use_rnn)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = NJODE(cfg).to(dev)
    return cfg, model


def _climate_gob(dev, seed=0):
    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob

    cfg = gob.GOBConfig(input_size=5, hidden_size=50, p_hidden=25,
                        prep_hidden=10, cov_size=5, cov_hidden=50,
                        logvar=True, mixing=1e-4, dropout_rate=0.2,
                        full_gru_ode=True, impute=False)
    model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
    return cfg, model.to(dev)


def _masked_checks(spec, leaves, arrays, h0, u, seed, tol, tag):
    """K1 and K2 twice bit for bit and against the plain versions (the
    plain calls timed once with CUDA events); returns (errors, plain ms,
    K1's histories)."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    runs = [fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True, u, seed)
            for _ in range(2)]
    (lk, hk), (lk2, hk2) = runs
    torch.cuda.synchronize()
    if not (torch.equal(lk, lk2) and all(
            torch.equal(a, b) for a, b in zip(hk, hk2))):
        raise AssertionError(f"masked K1 ({tag}) differs between two runs")
    ms = {}
    if tol.get("stepwise"):
        e_loss, e_hist, lp, ms["K1m"] = _stepwise_check(
            f"masked K1 ({tag})", spec, leaves, arrays, lk, hk, True, u, seed,
            tol)
        e = {"loss": e_loss, "hist": e_hist, "loss_val": float(lp)}
        # for the record: how far the free-running plain scan parts ways
        lf, _ = fs.scan_fwd_plain(spec, leaves, arrays, 0.5, h0, True, u,
                                  seed, want_hists=False)
        e["free_run_gap"] = float((lk - lf).abs() / lf.abs())
    else:
        (lp, hp), ms["K1m"] = timed(lambda: fs.scan_fwd_plain(
            spec, leaves, arrays, 0.5, h0, True, u, seed))
        e = {"loss": check_close(f"masked K1 loss ({tag})", lk, lp,
                                 tol["loss"]),
             "loss_val": float(lp)}
        e["hist"] = max(check_close(f"masked K1 {n} ({tag})", a, b,
                                    tol["hist"] or scaled_tol(b))
                        for n, a, b in zip(("h", "lastX", "tau"), hk, hp))
    dloss = torch.ones((), device=h0.device)
    outs = [fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, True, hk, dloss, u,
                             seed) for _ in range(2)]
    torch.cuda.synchronize()
    (gk, dk), (gk2, dk2) = outs
    if not (torch.equal(dk, dk2) and all(
            torch.equal(a, b) for a, b in zip(gk, gk2))):
        raise AssertionError(f"masked K2 ({tag}) differs between two runs")
    (gp, dp), ms["K2m"] = timed(lambda: fs.scan_bwd_plain(
        spec, leaves, arrays, 0.5, True, hk, dloss, u, seed))
    e.update(_grad_errs(f"masked K2 ({tag})", gk, gp, tol["grad"]))
    e["dh0"] = check_close(f"masked K2 dh0 ({tag})", dk, dp,
                           tol["grad"] or scaled_tol(dp))
    return e, ms, hk


def _stepwise_check(name, spec, leaves, arrays, lk, hk, train, u, seed,
                    tol):
    """A forward kernel's loss ``lk`` and step-entry carries ``hk`` against
    the plain step map started from those carries
    (``fused_scan.scan_steps_plain``, timed once with CUDA events); returns
    (loss error, largest carry error, plain loss, plain ms)."""
    from njode_tpu_torch.ops import fused_scan as fs

    (lp, nxt), ms = timed(lambda: fs.scan_steps_plain(
        spec, leaves, arrays, 0.5, hk, train, u, seed))
    e_loss = check_close(f"{name} loss", lk, lp, tol["loss"])
    e_hist = max(check_close(f"{name} {n}", a[1:], b[:-1],
                             tol["hist"] or scaled_tol(b[:-1]))
                 for n, a, b in zip(("h", "lastX", "tau"), hk, nxt))
    return e_loss, e_hist, lp, ms


def _grad_errs(name, gk, gp, tol=None):
    """Each gradient leaf against its plain version, at ``tol`` or (None)
    at the leaf's own ``scaled_tol``: the largest absolute error, the
    largest error relative to its leaf's largest |g|, and the largest share
    of the tolerance used (|a - b| / (atol + rtol |b|), 1 at the limit)."""
    e = {"grad": 0.0, "grad_rel": 0.0, "grad_used": 0.0}
    for i, (a, b) in enumerate(zip(gk, gp)):
        t = tol or scaled_tol(b)
        e["grad"] = max(e["grad"], check_close(f"{name} grad {i}", a, b, t))
        e["grad_rel"] = max(e["grad_rel"],
                            max_err(a, b) / max(float(b.abs().max()), 1e-30))
        e["grad_used"] = max(e["grad_used"], float(
            ((a.double() - b.double()).abs()
             / (t["atol"] + t["rtol"] * b.double().abs())).max()))
    return e


def _masked_arm_checks(phase, cfg, model, full, runs, gen, plan=None,
                       **tags):
    """The masked K1 and K2 (``_masked_checks``) and K3, each twice bit for
    bit and against its plain version, over the first K steps of the batch
    ``full`` for each ``(K, modes, tol)`` of ``runs``, in ``plan`` (None:
    the spec's own). Returns (the largest error of each kernel, the plain
    versions' ms and ``(leaves, arrays, h0, seed, hists)`` of the last
    run)."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = full.obs.device
    B = full.obs.shape[1]
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    errs = {"K1m": 0.0, "K2m": 0.0, "K3m": 0.0}
    for K, modes, tol in runs:
        b = _first_steps(full, K)
        arrays = fs.batch_arrays(b)
        with torch.no_grad():
            h0 = fs.t0_state(model, b)
        for mode in modes:
            spec = fs.Spec(cfg, mode, plan)
            u = seed = None
            if mode == "input":
                u = (torch.rand((K, spec.S, B, spec.w_max),
                                generator=gen, device=dev) < 0.9).to(
                    torch.int8)
            else:
                seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                     device=dev, dtype=torch.int64)
            tag = " ".join([*map(str, tags.values()), f"K={K}", mode])
            e, plain_ms, hists = _masked_checks(spec, leaves, arrays, h0, u,
                                                seed, tol, tag)
            errs["K1m"] = max(errs["K1m"], e["loss"])
            errs["K2m"] = max(errs["K2m"], e["grad"], e["dh0"])
            gap = ({"free_run_loss_gap": f"{e['free_run_gap']:.3e}"}
                   if "free_run_gap" in e else {})
            say(phase, **tags, K=K, mode=mode,
                loss=f"{e['loss_val']:.6f}", K1_loss_err=f"{e['loss']:.3e}",
                K1_hist_err=f"{e['hist']:.3e}",
                K2_grad_err=f"{e['grad']:.3e}",
                K2_grad_rel_err=f"{e['grad_rel']:.3e}",
                K2_grad_tol_used=f"{e['grad_used']:.3e}",
                K2_dh0_err=f"{e['dh0']:.3e}", **gap, bitwise_repeat=True)
        spec3 = fs.Spec(cfg, "input", plan)
        l3 = [fs.scan_fwd_cuda(spec3, leaves, arrays, 0.5, h0, False,
                               want_hists=False)[0] for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(l3[0], l3[1]):
            raise AssertionError(f"masked K3 ({tag}) differs between runs")
        if tol.get("stepwise"):
            # K1 without dropout walks K3's trajectory and keeps its carries
            le, he = fs.scan_fwd_cuda(spec3, leaves, arrays, 0.5, h0, False)
            if not torch.equal(le, l3[0]):
                raise AssertionError(f"masked K3 ({tag}) differs from K1 "
                                     "without dropout")
            e3, _, _, plain_k3 = _stepwise_check(
                f"masked K3 ({tag})", spec3, leaves, arrays, l3[0], he, False,
                None, None, tol)
        else:
            (l3p, _), plain_k3 = timed(lambda: fs.scan_fwd_plain(
                spec3, leaves, arrays, 0.5, h0, False, want_hists=False))
            e3 = check_close(f"masked K3 ({tag})", l3[0], l3p, tol["loss"])
        errs["K3m"] = max(errs["K3m"], e3)
        say(phase, **tags, K=K, K3_loss_err=f"{e3:.3e}",
            K3_loss=f"{float(l3[0]):.6f}", bitwise_repeat=True)
    plain_ms["K3m"] = plain_k3
    return errs, plain_ms, (leaves, arrays, h0, seed, hists)


def _gob_checks(spec, leaves, arrays, st, u, seed, tag):
    """K5 and K6 twice bit for bit and against the plain versions (the
    plain calls timed once with CUDA events), histories and gradients per
    leaf at ``scaled_tol``; returns (errors, plain ms, K5's histories)."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    runs = [fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, True, u, seed)
            for _ in range(2)]
    (lk, hk), (lk2, hk2) = runs
    torch.cuda.synchronize()
    if not (torch.equal(lk, lk2) and all(
            torch.equal(a, c) for a, c in zip(hk, hk2))):
        raise AssertionError(f"K5 climate ({tag}) differs between two runs")
    ms = {}
    (lp, hp), ms["K5c"] = timed(lambda: fg.gob_scan_fwd_plain(
        spec, leaves, arrays, *st, True, u, seed))
    e = {"loss": check_close(f"K5 climate loss ({tag})", lk, lp, LOSS_TOL),
         "loss_val": float(lp)}
    e["hist"] = max(check_close(f"K5 climate {n} ({tag})", a, c,
                                scaled_tol(c))
                    for n, a, c in zip("hmv", hk, hp))
    dloss = torch.ones((), device=lk.device)
    outs = [fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                                 seed) for _ in range(2)]
    torch.cuda.synchronize()
    (gk, *dk), (gk2, *dk2) = outs
    if not all(torch.equal(a, c) for a, c in
               zip(list(gk) + dk, list(gk2) + dk2)):
        raise AssertionError(f"K6 climate ({tag}) differs between two runs")
    (gp, *dp), ms["K6c"] = timed(lambda: fg.gob_scan_bwd_plain(
        spec, leaves, arrays, True, hk, dloss, u, seed))
    e.update(_grad_errs(f"K6 climate ({tag})", gk, gp))
    e["d0"] = max(check_close(f"K6 climate {n} ({tag})", a, c, scaled_tol(c))
                  for n, a, c in zip(("dh0", "dm0", "dv0"), dk, dp))
    return e, ms, hk


def phase_climate_kernels(results):
    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    dev = torch.device("cuda")
    full = results["climate"]["batch"]
    cfg, model = _masked_njode(5, 10, 50, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, plain_ms, last = _masked_arm_checks(
        "climate_kernels", cfg, model, full,
        ((100, ("input", "prng"), SHORT_TOL),
         (results["climate"]["K"], ("prng",), LONG_TOL)), gen)
    results["climate"].update(njode=(cfg, *last), plain_ms=plain_ms)
    check_waves("climate_kernels", "climate_small", cfg, CLIMATE_B)

    # K5/K6 at the GRU-ODE-Bayes climate arm: the first 100 steps in both
    # mask modes, all 2,004 in 'prng' mode (the trainer's shape)
    gcfg, gmodel = _climate_gob(dev)
    gleaves = [p.detach() for p in fg.flat_leaves(gmodel, fg.Spec(gcfg))]
    gerr = {"K5c": 0.0, "K6c": 0.0}
    for K, modes in ((100, ("input", "prng")),
                     (results["climate"]["K"], ("prng",))):
        b = _first_steps(full, K)
        garrays = (b.times, b.dt, b.obs, b.X, b.M)
        with torch.no_grad():
            h0 = gob.mlp2(gmodel.covariates_map, b.start_X, 0.0)
            p0 = gob.mlp2(gmodel.p_model, h0, 0.0)
        st = (h0.contiguous(), p0[:, :5].contiguous(), p0[:, 5:].contiguous())
        for mode in modes:
            spec = fg.Spec(gcfg, mode)
            u = seed = None
            if mode == "input":
                u = (torch.rand((K, 3, CLIMATE_B, spec.P), generator=gen,
                                device=dev) < 0.8).to(torch.int8)
            else:
                seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                     device=dev, dtype=torch.int64)
            e, gplain_ms, ghists = _gob_checks(spec, gleaves, garrays, st, u,
                                               seed, f"K={K} {mode}")
            gerr["K5c"] = max(gerr["K5c"], e["loss"])
            gerr["K6c"] = max(gerr["K6c"], e["grad"], e["d0"])
            say("climate_kernels", model="GOB", K=K, mode=mode,
                loss=f"{e['loss_val']:.6f}", K5_loss_err=f"{e['loss']:.3e}",
                K5_hist_err=f"{e['hist']:.3e}",
                K6_grad_err=f"{e['grad']:.3e}",
                K6_grad_rel_err=f"{e['grad_rel']:.3e}",
                K6_grad_tol_used=f"{e['grad_used']:.3e}",
                K6_d0_err=f"{e['d0']:.3e}", bitwise_repeat=True)
    plain_ms.update(gplain_ms)
    results["climate"]["gob"] = (gcfg, gleaves, garrays, st, seed, ghists)
    results["climate_errs"] = dict(errs, **gerr)


def _masked_times(spec, spec3, leaves, arrays, h0, seed, hists, reps):
    """CUDA-event ms of the masked K1 and K2 (``spec``, 'prng') and of K3
    (``spec3``), one warm-up and ``reps`` timed calls each."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dloss = torch.ones((), device=h0.device)
    return {"K1": cuda_ms(lambda: fs.scan_fwd_cuda(
                spec, leaves, arrays, 0.5, h0, True, None, seed), reps, 1),
            "K2": cuda_ms(lambda: fs.scan_bwd_cuda(
                spec, leaves, arrays, 0.5, True, hists, dloss, None, seed),
                reps, 1),
            "K3": cuda_ms(lambda: fs.scan_fwd_cuda(
                spec3, leaves, arrays, 0.5, h0, False, want_hists=False),
                reps, 1)}


def _scan_bounds(spec, K, B):
    """Bounds of K1, K2 and K3 at K steps of B rows in the spec's plan
    and branch: the FLOP from the MACs per row-step (backward 3x), the
    bytes with each input read once (X, and M when masked) and each output
    written once (K2's output holds one partial row per CTA)."""
    mac = _macs_per_row_step(spec)
    D, H, P = spec.D, spec.H, spec.n_params
    n_fwd = -(-B // spec.rows_for(B, False))
    n_bwd = -(-B // spec.rows_for(B))
    nX = 2 if spec.masked else 1
    data = 4 * (2 * K + K * B + nX * K * B * D + B + B * D + B * H + P)
    hist = 4 * K * B * (H + D + 1)
    f1 = 2.0 * mac * B * K
    return {"K1": bound(f1, data + 8 + hist + 4 * n_fwd, PEAK_FP32),
            "K2": bound(3.0 * f1, data + 8 + hist + 4 + 4 * n_bwd * P
                        + 4 * B * H, PEAK_FP32),
            "K3": bound(f1, data + 4 * n_fwd, PEAK_FP32)}


def phase_climate_timing(results):
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs

    cl = results["climate"]
    cfg, leaves, arrays, h0, seed, hists = cl["njode"]
    K, B = arrays[2].shape
    dloss = torch.ones((), device=h0.device)
    spec = fs.Spec(cfg, "prng")
    ms = _masked_times(spec, fs.Spec(cfg, "input"), leaves, arrays, h0,
                       seed, hists, 3)
    mask_cost_njode("climate_timing", "climate_small", cfg, leaves, arrays,
                    h0, 2)
    t = {k + "m": (ms[k], cl["plain_ms"][k + "m"]) for k in ms}
    bnd = {k + "m": v for k, v in _scan_bounds(spec, K, B).items()}

    gcfg, gleaves, garrays, st, gseed, ghists = cl["gob"]
    gspec = fg.Spec(gcfg, "prng")
    t["K5c"] = (cuda_ms(lambda: fg.gob_scan_fwd_cuda(
        gspec, gleaves, garrays, *st, True, None, gseed), 2, 1),
        cl["plain_ms"]["K5c"])
    gbwd = lambda: fg.gob_scan_bwd_cuda(  # noqa: E731
        gspec, gleaves, garrays, True, ghists, dloss, None, gseed)
    t["K6c"] = (cuda_ms(gbwd, 2, 1), cl["plain_ms"]["K6c"])
    stages = stage_device_ms(gbwd, 2)
    say("climate_timing", kernel="K6c_stages", R=gspec.rows_for(B),
        chunks=-(-K // gspec.bwd_chunk(K, B)),
        **{f"{n}_device_ms": f"{v:.4f}" for n, v in stages.items()})
    mask_cost_gob("climate_timing", "climate_gob", gcfg, gleaves, garrays,
                  st, 2)
    (f5, b5), (f6, b6) = gob_bounds(gspec, K, B)
    bnd["K5c"] = bound(f5, b5, PEAK_FP32)
    bnd["K6c"] = bound(f6, b6, PEAK_FP32)
    results["times"].update(t)
    results["bounds"].update(bnd)
    for k in ("K1m", "K2m", "K3m", "K5c", "K6c"):
        ms, plain = t[k]
        bms, by = bnd[k]
        say("climate_timing", kernel=k, B=B, K=K, ms=f"{ms:.4f}",
            ms_per_step=f"{ms / K:.5f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bms:.6f}", bound_by=by,
            roofline_share=f"{bms / ms:.2e}")


def _climate_run(results, tag, expect, epochs=2, rows_cfg=None, **kw):
    """One ``climate_trainer.train`` run of ``epochs`` epochs with every
    count set to 0 just before and read just after; checks the metric CSV
    and the counts (and, given the NJODE config ``rows_cfg``, the rows of
    each scan launch)."""
    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import climate_trainer as ct
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    d = results["climate"]["dir"]
    models = os.path.join(d, "models_" + tag)
    fs.reset_launch_counts()
    fg.reset_launch_counts()
    chunks = BwdChunks()
    with chunks:
        ct.train(epochs=epochs, batch_size=CLIMATE_B, climate_dir=d,
                 saved_models_path=models, device="cuda", **kw)
    torch.cuda.synchronize()
    if callable(expect):
        expect = expect(chunks)
    counts = dict(fs.LAUNCHES, **fg.LAUNCHES)
    cols, rows = read_frame(os.path.join(models, "id-1", "metric_id-1.csv"))
    if len(rows) != epochs:
        raise AssertionError(f"{tag}: expected {epochs} metric rows, "
                             f"got {rows}")
    for row in rows:
        rec = dict(zip(cols, row))
        vals = {k: to_float(rec[k]) for k in cols if k != "epoch"}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{tag}: non-finite metrics: {rec}")
        say("climate_trainer", arm=tag, epoch=rec["epoch"],
            **{k: f"{v:.6f}" for k, v in vals.items()})
    for k, v in counts.items():
        if counts[k] != expect.get(k, 0):
            raise AssertionError(f"{tag}: launch count {k}={counts[k]}, "
                                 f"expected {expect.get(k, 0)}: {counts}")
    say("climate_trainer", arm=tag,
        launches=json.dumps({k: v for k, v in counts.items() if v})
        .replace(" ", ""))
    if rows_cfg is not None:
        check_rows("climate_trainer", rows_cfg)
    return counts


def phase_climate_trainer(results):
    n_batches = -(-results["climate"]["n_train"] // CLIMATE_B)
    steps = 2 * n_batches            # 2 epochs; eval runs the eager forward
    nj = _climate_run(results, "njode", {
        "njode_scan_fwd": steps, "njode_scan_bwd": steps,
        "philox_keep": 2 * steps, "reduce_partials": 2 * steps},
        rows_cfg=_masked_cfg(5, 10, 50), hidden_size=10, dropout_rate=0.1)
    gb = _climate_run(results, "gob", lambda chunks: chunks.expect(steps),
        hidden_size=50, dropout_rate=0.2, ode_nn=None, readout_nn=None,
        enc_nn=None, other_model="GRU_ODE_Bayes",
        **{"GRU_ODE_Bayes-impute": False, "GRU_ODE_Bayes-logvar": True,
           "GRU_ODE_Bayes-mixing": 1e-4, "GRU_ODE_Bayes-p_hidden": 25,
           "GRU_ODE_Bayes-prep_hidden": 10,
           "GRU_ODE_Bayes-cov_hidden": 50})
    results["climate_launches"] = dict(njode=nj, gob=gb)


def physionet_setup(results):
    """The stand-in at the published scale, its split, the pre-stacked bank
    on the card and epoch 1's first training batch."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import physionet as pdu
    from njode_tpu_torch.training import climate_trainer as ct
    from njode_tpu_torch.training.steps import prestacked_batch

    dev = torch.device("cuda")
    t0 = time.time()
    recs = pdu.make_synthetic_records(PHYS_RECORDS, quantization=PHYS_QUANT,
                                      seed=0)
    data = pdu.parse_datasets("", records=recs)
    tr, te = data["train_records"], data["test_records"]
    delta_t = PHYS_QUANT / 48.0
    K = pdu.max_union_grid_steps(tr + te, delta_t, PHYS_T)
    pre = pdu.prestack_train_records(tr, data["data_min"], data["data_max"],
                                     delta_t, PHYS_T, K)
    E, D = pre["k"].shape[1], pre["X"].shape[2]
    bank = [torch.as_tensor(a, device=dev) for a in (
        np.concatenate([pre["k"], np.full((1, E), K, np.int32)]).astype(
            np.int64),
        np.concatenate([pre["X"], np.zeros((1, E, D), np.float32)]),
        np.concatenate([pre["M"], np.zeros((1, E, D), np.float32)]))]
    idx_mat, _, _ = ct.epoch_batches(398, 1, len(tr), PHYS_B)
    batch = prestacked_batch(*bank, torch.as_tensor(idx_mat[0], device=dev),
                             torch.as_tensor(pre["times"], device=dev),
                             torch.as_tensor(pre["dt"], device=dev))
    torch.cuda.synchronize()
    results["phys"] = dict(records=recs, batch=batch,
                           bank=(bank, torch.as_tensor(pre["times"],
                                                       device=dev),
                                 torch.as_tensor(pre["dt"], device=dev),
                                 len(tr)))
    say("physionet_setup", records=len(recs), n_train=len(tr),
        n_test=len(te), K=int(batch.obs.shape[0]), B=PHYS_B,
        rows_mean=f"{pre['n_ev'].mean():.1f}", rows_max=int(E),
        bank_GB=f"{(pre['X'].nbytes + pre['M'].nbytes) / 1e9:.3f}",
        batch_obs=int(batch.obs.sum()), setup_s=f"{time.time() - t0:.2f}")


def _kernel_outputs(spec, spec3, leaves, arrays, h0, u, seed):
    """Every output of K1 (loss, histories), K2 (gradients, dh0) and K3."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    l1, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True, u,
                                 seed)
    g, dh0 = fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, True, hists,
                              torch.ones((), device=h0.device), u, seed)
    l3, _ = fs.scan_fwd_cuda(spec3, leaves, arrays, 0.5, h0, False,
                             want_hists=False)
    return [l1, *hists, *g, dh0, l3]


def _plans_bit_identical(tag, cfg, leaves, arrays, h0, gen,
                         phase="physionet_kernels"):
    """The global plan against the resident plan at the same rows, every
    output of K1, K2 and K3 in both mask modes, bit for bit: both forced at
    16 rows, and the global plan forced at the rows the rule takes at this
    batch (one a CTA) against the rule's own launches."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    K, B = arrays[2].shape
    own = fs.Spec(cfg)
    R = own.rows_for(B)
    if own.plan != "resident" or own.rows_for(B, False) != R:
        raise AssertionError(f"{tag}: plan {own.plan}, K2 at {R} rows, K1 "
                             f"at {own.rows_for(B, False)}")
    for mode in ("input", "prng"):
        spec = fs.Spec(cfg, mode)
        u = seed = None
        if mode == "input":
            u = (torch.rand((K, spec.S, B, spec.w_max), generator=gen,
                            device=h0.device) < 0.9).to(torch.int8)
        else:
            seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=h0.device, dtype=torch.int64)
        for pair in ((("resident", 16), ("global", 16)),
                     (None, ("global", R))):
            outs = [_kernel_outputs(fs.Spec(cfg, mode, plan),
                                    fs.Spec(cfg, "input", plan), leaves,
                                    arrays, h0, u, seed) for plan in pair]
            torch.cuda.synchronize()
            n_diff = sum(not torch.equal(a, b) for a, b in zip(*outs))
            if n_diff:
                raise AssertionError(
                    f"global plan at {pair[1][1]} rows differs from the "
                    f"resident plan in {n_diff} outputs ({tag} {mode})")
            say(phase, plans_bit_identical=tag, mode=mode,
                rows=pair[1][1], rule=pair[0] is None,
                outputs=len(outs[0]))


# (arm, D, hidden, width, the batch it runs on, the plan checked and
# timed: the rule's own, or the global plan forced where the rule now
# takes the resident plan, the seed of its masks' draws)
PHYS_ARMS = (("phys50", 41, 41, 50, "phys", ("global", 16), 41),
             ("phys200", 41, 41, 200, "phys", None, 42),
             ("climate400", 5, 50, 400, "climate", None, 43))


def phase_physionet_kernels(results):
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    st = results["setup"]
    _plans_bit_identical("main_path", st["cfg"], st["leaves"], st["arrays"],
                         st["h0"], gen)
    cfg_c, model_c = _masked_njode(5, 10, 50, dev)
    b = _first_steps(results["climate"]["batch"], 100)
    with torch.no_grad():
        h0_c = fs.t0_state(model_c, b)
    _plans_bit_identical("climate_small", cfg_c,
                         [p.detach() for p in fs.flat_leaves(model_c)],
                         fs.batch_arrays(b), h0_c, gen)

    # each arm draws its masks from a generator of its own, so no check's
    # draws depend on which checks ran before it
    arms, errs = {}, {"K1m": 0.0, "K2m": 0.0, "K3m": 0.0}
    for arm, D, H, width, src, plan, draw in PHYS_ARMS:
        full = results[src]["batch"]
        cfg, model = _masked_njode(D, H, width, dev)
        own = fs.Spec(cfg)
        spec = fs.Spec(cfg, "prng", plan)
        if spec.plan != "global" or (plan is None) != (own.plan == "global"):
            raise AssertionError(f"{arm}: plan {own.plan} at {own.rows} "
                                 f"rows, checked {spec.plan}")
        check_waves("physionet_kernels", arm, cfg, int(full.obs.shape[1]))
        say("physionet_kernels", arm=arm, plan=own.plan, rows=own.rows,
            smem_bytes=own.smem_bytes, checked_plan=spec.plan,
            checked_rows=spec.rows, checked_smem_bytes=spec.smem_bytes,
            n_params=spec.n_params,
            macs_per_row_step=_macs_per_row_step(spec))
        short = SHORT_STEP_TOL if src == "phys" else SHORT_TOL
        runs = ((100, ("input", "prng"), short),)
        if arm == "phys50":          # the trainer's shape, all steps
            runs += ((int(full.obs.shape[0]), ("prng",), STEP_TOL),)
        e, plain_ms, _ = _masked_arm_checks(
            "physionet_kernels", cfg, model, full, runs,
            torch.Generator(device=dev).manual_seed(draw), plan, arm=arm)
        errs = {k: max(errs[k], e[k]) for k in errs}
        arms[arm] = dict(cfg=cfg, model=model, full=full, plain_ms=plain_ms,
                         plan=plan, own=own.plan, draw=draw, short=short)
    # then each arm forced into the global plan in the rule's own plan,
    # the trainer's, on the same draws
    for arm, a in arms.items():
        if a["plan"] is not None:
            _masked_arm_checks(
                "physionet_kernels", a["cfg"], a["model"], a["full"],
                ((100, ("input", "prng"), a["short"]),),
                torch.Generator(device=dev).manual_seed(a["draw"]),
                arm=arm, plan_checked=a["own"])
    results["phys"].update(arms=arms, errs=errs)


def phase_physionet_timing(results):
    t, bnd = {}, {}
    for arm, a in results["phys"]["arms"].items():
        # the global plan (the rule's or forced), and at phys50 the rule's
        # resident plan (one row a CTA) beside it
        for plan in (a["plan"], None) if a["plan"] else (None,):
            ms, bd, K, B, spec = _full_grid_times(
                a["cfg"], a["model"], a["full"],
                3 if arm == "phys50" else 2, plan)
            _say_times("physionet_timing", arm, spec, ms, bd, K, B)
            if arm == "phys50" and spec.plan == "global":
                for k in ("K1", "K2", "K3"):
                    t[k + "g"] = (ms[k], a["plain_ms"][k + "m"])
                    bnd[k + "g"] = bd[k]
            if arm == "phys50" and spec.plan == "resident":
                mask_cost_physionet(a, 2)
    results["times"].update(t)
    results["bounds"].update(bnd)


def mask_cost_physionet(a, reps):
    """The masks' cost inside K1 and K2 of the PhysioNet 50 arm in the
    rule's resident plan over the first batch's 3,006 steps."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    leaves = [p.detach() for p in fs.flat_leaves(a["model"])]
    with torch.no_grad():
        h0 = fs.t0_state(a["model"], a["full"])
    mask_cost_njode("physionet_timing", "physionet_50", a["cfg"], leaves,
                    fs.batch_arrays(a["full"]), h0, reps)


def _physionet_run(results, phase, epochs, expect,
                   n_records=PHYS_TRAIN_RECORDS, rows_cfg=None, **kw):
    """One ``physionet_trainer.train`` run (batch 50, 'prng'; the 50 arm
    unless ``kw`` sets the widths) on the stand-in cut to ``n_records``
    records, with every count set to 0 just before and read just after;
    checks the metric CSV and that every count is what ``expect`` says (0
    where it has no key)."""
    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import physionet_trainer as pt
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    tmp = tempfile.mkdtemp(prefix="njode_smoke_phys_")
    try:
        recs = results["phys"]["records"][:n_records]
        models = os.path.join(tmp, "models")
        fs.reset_launch_counts()
        fg.reset_launch_counts()
        pt.train(epochs=epochs, batch_size=PHYS_B, quantization=PHYS_QUANT,
                 n_samples=n_records, records=recs,
                 saved_models_path=models, device="cuda",
                 pallas_mask_mode="prng", **kw)
        torch.cuda.synchronize()
        counts = dict(fs.LAUNCHES, **fg.LAUNCHES)
        cols, rows = read_frame(os.path.join(models, "id-1",
                                             "metric_id-1.csv"))
        if len(rows) != epochs:
            raise AssertionError(f"expected {epochs} metric rows, got {rows}")
        for row in rows:
            rec = dict(zip(cols, row))
            vals = {k: to_float(rec[k]) for k in cols if k != "epoch"}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"non-finite PhysioNet metrics: {rec}")
            say(phase, epoch=rec["epoch"],
                **{k: f"{v:.6f}" for k, v in vals.items()})
        say(phase, records=len(recs))
        _check_counts(phase, counts, expect)
        if rows_cfg is not None:
            check_rows(phase, rows_cfg)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_physionet_trainer(results):
    steps = 2 * -(-int(0.8 * PHYS_TRAIN_RECORDS) // PHYS_B)
    # the 50 arm takes the resident plan, one row a CTA (the rule)
    results["phys_launches"] = _physionet_run(
        results, "physionet_trainer", 2,
        {"njode_scan_fwd": steps, "njode_scan_bwd": steps,
         "philox_keep": 2 * steps, "reduce_partials": 2 * steps},
        rows_cfg=_masked_cfg(41, 41, 50))
    # one epoch of the 200 arm, the global plan at 8 rows with the encoder
    # jump, on the stand-in cut to PHYS_200_RECORDS records
    n_b = -(-int(0.8 * PHYS_200_RECORDS) // PHYS_B)
    nn = ((200, "tanh"), (200, "tanh"))
    results["phys200_launches"] = _physionet_run(
        results, "physionet_trainer_200", 1,
        {"njode_scan_fwd_global": n_b, "njode_scan_bwd_global": n_b,
         "philox_keep": 2 * n_b, "reduce_partials": 2 * n_b},
        n_records=PHYS_200_RECORDS, rows_cfg=_masked_cfg(41, 41, 200),
        ode_nn=nn, readout_nn=nn, enc_nn=nn)


def _check_plan(phase, arm, spec, plan):
    """Fail unless ``spec`` takes ``plan`` at 16 rows; print its sizes."""
    if (spec.plan, spec.rows) != (plan, 16):
        raise AssertionError(f"{arm}: plan {spec.plan} at {spec.rows} rows, "
                             f"expected {plan} at 16")
    say(phase, arm=arm, plan=spec.plan, rows=spec.rows,
        smem_bytes=spec.smem_bytes, n_params=spec.n_params,
        macs_per_row_step=_macs_per_row_step(spec))


def _full_grid_times(cfg, model, full, reps, plan=None):
    """CUDA-event ms of K1, K2 ('prng') and K3 over the whole batch
    ``full`` in ``plan`` (None: the spec's own) and their bounds; returns
    (ms, bounds, K, B, the 'prng' spec)."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    leaves = [p.detach() for p in fs.flat_leaves(model)]
    arrays = fs.batch_arrays(full)
    K, B = arrays[2].shape
    with torch.no_grad():
        h0 = fs.t0_state(model, full)
    seed = torch.tensor([20261016], dtype=torch.int64, device=h0.device)
    spec = fs.Spec(cfg, "prng", plan)
    _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True, None,
                                seed)
    ms = _masked_times(spec, fs.Spec(cfg, "input", plan), leaves, arrays, h0,
                       seed, hists, reps)
    return ms, _scan_bounds(spec, K, B), K, B, spec


def _say_times(phase, arm, spec, ms, bd, K, B):
    for k in ("K1", "K2", "K3"):
        bms, by = bd[k]
        say(phase, arm=arm, plan=spec.plan,
            rows=spec.rows_for(B, k == "K2"), kernel=k, B=B,
            K=K, ms=f"{ms[k]:.4f}", ms_per_step=f"{ms[k] / K:.5f}",
            bound_ms=f"{bms:.6f}", bound_by=by,
            roofline_share=f"{bms / ms[k]:.2e}")



def phase_rnn_kernels(results):
    """The GRU jump (use_rnn) of K1, K2 and K3 at the main path's widths
    against their plain versions (B = 200, K = 100, both mask modes; K3
    also at B = 4,000), each twice bit for bit, and the global plan forced
    at 16 rows bit for bit against the resident plan."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    B, K = 200, 100
    cfg, model, batch = main_path_setup(B, K, 0, dev, use_rnn=True)
    _check_plan("rnn_kernels", "main_path", fs.Spec(cfg), "resident")
    gen = torch.Generator(device=dev).manual_seed(6)
    errs, plain_ms, last = _masked_arm_checks(
        "rnn_kernels", cfg, model, batch,
        ((K, ("input", "prng"), SHORT_TOL),),
        gen, arm="main_path")
    leaves, arrays, h0, _, _ = last
    _plans_bit_identical("rnn_main_path", cfg, leaves, arrays, h0, gen,
                         phase="rnn_kernels")
    B3 = 4000
    cfg3, model3, batch3 = main_path_setup(B3, K, 2, dev, use_rnn=True)
    leaves3 = [p.detach() for p in fs.flat_leaves(model3)]
    arrays3 = fs.batch_arrays(batch3)
    with torch.no_grad():
        h03 = fs.t0_state(model3, batch3)
    spec3 = fs.Spec(cfg3, "input")
    l3 = [fs.scan_fwd_cuda(spec3, leaves3, arrays3, 0.5, h03, False,
                           want_hists=False)[0] for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(l3[0], l3[1]):
        raise AssertionError("rnn K3 (B=4000) differs between two runs")
    (l3p, _), plain_k3 = timed(lambda: fs.scan_fwd_plain(
        spec3, leaves3, arrays3, 0.5, h03, False, want_hists=False))
    e3 = check_close("rnn K3 loss (B=4000)", l3[0], l3p, LOSS_TOL)
    say("rnn_kernels", arm="main_path", B=B3, K3_loss_err=f"{e3:.3e}",
        K3_loss=f"{float(l3[0]):.6f}", bitwise_repeat=True)
    for Bw in (100, B, B3):
        check_waves("rnn_kernels", "main_path", cfg, Bw)
    results["rnn"] = dict(cfg=cfg, last=last,
                          k3=(spec3, leaves3, arrays3, h03),
                          plain_ms=dict(plain_ms, K3=plain_k3),
                          errs=dict(errs, K3=e3))


def phase_rnn_timing(results):
    """CUDA-event times and bounds of the GRU jump's K1/K2 (B = 200) and
    K3 (B = 4,000) at the main path, beside the encoder jump's."""
    from njode_tpu_torch.ops import fused_scan as fs

    rn = results["rnn"]
    cfg = rn["cfg"]
    leaves, arrays, h0, seed, hists = rn["last"]
    K, B = arrays[2].shape
    spec = fs.Spec(cfg, "prng")
    ms = _masked_times(spec, fs.Spec(cfg, "input"), leaves, arrays, h0, seed,
                       hists, 20)
    spec3, leaves3, arrays3, h03 = rn["k3"]
    K3, B3 = arrays3[2].shape
    ms["K3"] = cuda_ms(lambda: fs.scan_fwd_cuda(
        spec3, leaves3, arrays3, 0.5, h03, False, want_hists=False), 10)
    bd = _scan_bounds(spec, K, B)
    bd["K3"] = _scan_bounds(spec3, K3, B3)["K3"]
    pm = rn["plain_ms"]
    plain = {"K1": pm["K1m"], "K2": pm["K2m"], "K3": pm["K3"]}
    for k in ("K1", "K2", "K3"):
        bms, by = bd[k]
        results["times"][k + "r"] = (ms[k], plain[k])
        results["bounds"][k + "r"] = bd[k]
        say("rnn_timing", kernel=k, B=B3 if k == "K3" else B, K=K,
            ms=f"{ms[k]:.4f}", plain_ms=f"{plain[k]:.4f}",
            bound_ms=f"{bms:.6f}", bound_by=by,
            roofline_share=f"{bms / ms[k]:.2e}",
            vs_encoder_jump=f"{ms[k] / results['times'][k][0]:.3f}")


def phase_climate_rnn(results):
    """The masked GRU jump at the climate small arm: K1-K3 against their
    plain versions on the first climate batch's first 100 steps in both
    modes, CUDA-event times and bounds over all its steps, and one epoch
    of ``climate_trainer.train(use_rnn=True)`` with exact launch counts."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    full = results["climate"]["batch"]
    cfg, model = _masked_njode(5, 10, 50, dev, use_rnn=True)
    _check_plan("climate_rnn", "climate_small", fs.Spec(cfg), "resident")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs, plain_ms, _ = _masked_arm_checks(
        "climate_rnn", cfg, model, full,
        ((100, ("input", "prng"), SHORT_TOL),),
        gen, arm="climate_small")
    ms, bd, K, B, spec = _full_grid_times(cfg, model, full, 2)
    _say_times("climate_rnn", "climate_small", spec, ms, bd, K, B)
    n_b = -(-results["climate"]["n_train"] // CLIMATE_B)
    counts = _climate_run(results, "njode_rnn", {
        "njode_scan_fwd_rnn": n_b, "njode_scan_bwd_rnn": n_b,
        "philox_keep": 2 * n_b, "reduce_partials": 2 * n_b}, epochs=1,
        rows_cfg=cfg, hidden_size=10, dropout_rate=0.1, use_rnn=True)
    results["climate_rnn"] = dict(errs=errs, launches=counts, ms=ms, bd=bd)


def phase_physionet_rnn(results):
    """The masked GRU jump at the PhysioNet 50 arm in the global plan:
    K1-K3 against their plain versions over the first 100 steps of the
    first batch in both modes, and CUDA-event times and bounds over all
    3,006 steps."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    full = results["phys"]["batch"]
    cfg, model = _masked_njode(41, 41, 50, dev, use_rnn=True)
    _check_plan("physionet_rnn", "phys50", fs.Spec(cfg), "global")
    gen = torch.Generator(device=dev).manual_seed(8)
    errs, _, _ = _masked_arm_checks(
        "physionet_rnn", cfg, model, full,
        ((100, ("input", "prng"), SHORT_TOL),),
        gen, arm="phys50")
    ms, bd, K, B, spec = _full_grid_times(cfg, model, full, 2)
    _say_times("physionet_rnn", "phys50", spec, ms, bd, K, B)
    # one epoch of the trainer with the GRU jump: the global plan's path
    n_b = -(-int(0.8 * PHYS_TRAIN_RECORDS) // PHYS_B)
    counts = _physionet_run(
        results, "physionet_rnn", 1,
        {"njode_scan_fwd_rnn_global": n_b, "njode_scan_bwd_rnn_global": n_b,
         "philox_keep": 2 * n_b, "reduce_partials": 2 * n_b},
        rows_cfg=cfg, use_rnn=True)
    results["phys_rnn"] = dict(errs=errs, ms=ms, bd=bd, launches=counts)


# the sweep phase's depth cut: one epoch of each run, on the convergence
# study's own smallest training size and on SWEEP_TRAIN paths elsewhere
SWEEP_TRAIN = {20: 1000, 100: 2000}     # batch size -> training paths
# widths whose nets take the global plan (checked against fused_scan.Spec)
SWEEP_GLOBAL_WIDTHS = (100, 160, 320, 400)
# heston_wo_feller's 2-D return_vol dataset (experiments/configs.py)
HWOF_RV = {"drift": 2.0, "volatility": 3.0, "mean": 1.0, "speed": 2.0,
           "correlation": 0.5, "S0": 1, "maturity": 1.0, "dimension": 2,
           "scheme": "euler", "return_vol": True, "v0": 0.5}
# K1/K2 (with K3) against their plain versions at every shape the sweep's
# unmasked runs take: (arm, width, B, the plan and rows the rule must take,
# (SDE model, hyperparameters) of the batch, timed). Timed: the global-plan
# shapes and the 2-D one; the convergence study's global arms are timed
# again forced to one row a CTA (20 CTAs at B = 20), the rows a batch-aware
# rule would take (ROADMAP Queue 2 levers). The resident arms at B = 20
# (the convergence study's widths 10-80, the GRU-ODE-Bayes comparison's
# NJODE at 50) are only checked.
BS = ("BlackScholes", {})
SWEEP_SHAPES = (("sine400", 400, 100, ("global", 4), BS, True),
                ("conv320", 320, 20, ("global", 8), BS, True),
                ("conv160", 160, 20, ("global", 16), BS, True),
                ("combined100", 100, 100, ("global", 16), BS, True),
                ("hwof_rv50", 50, 100, ("resident", 1),
                 ("HestonWOFeller", HWOF_RV), True),
                *((f"conv{w}", w, 20, ("resident", 1), BS, False)
                  for w in (10, 20, 40, 80)),
                ("gob_cmp_njode50", 50, 20, ("resident", 1), BS, False))


def sweep_entries(results, data, models):
    """The published grids built through the port's experiments/configs.py
    at their widths and hyperparameters, their datasets created on the card
    (20,000 paths each), and the entries the phase runs, cut to one epoch:
    ``[(tag, kind, param dict)]``, kind 'njode', 'gob', 'climate' or
    'physionet'."""
    from njode_tpu_torch.experiments import configs

    t0 = time.time()
    configs.ensure_base_datasets(base_path=data)
    hwof, _ = configs.heston_wo_feller(epochs=1, base_path=data)
    comb, _ = configs.combined_regime(epochs=1, base_path=data)
    sine, _ = configs.sine_models(epochs=1, base_path=data,
                                  saved_models_path=models)
    n_sets = len(os.listdir(data)) - 1        # less dataset_overview.csv
    say("sweep", datasets=n_sets, paths=20000,
        datasets_s=f"{time.time() - t0:.2f}")
    conv, _ = configs.convergence_study(epochs=1, repeats=1,
                                        saved_models_path=models)
    gobc, _ = configs.gru_ode_bayes_comparison(epochs=1,
                                               saved_models_path=models)
    clim, _ = configs.climate_cross_validation(epochs=1)
    phys, _ = configs.physionet_comparison(epochs=1, repeats=1,
                                           saved_models_path=models)
    width = lambda p: p["ode_nn"][0][0]  # noqa: E731
    gob_nj = [p for p in gobc if "other_model" not in p
              and p["dataset"] == "BlackScholes"]
    gob_50 = [p for p in gobc if "other_model" in p
              and p["dataset"] == "BlackScholes" and p["hidden_size"] == 50
              and p["GRU_ODE_Bayes-impute"] and p["GRU_ODE_Bayes-logvar"]
              and p["GRU_ODE_Bayes-mixing"] == 1e-4]
    where = dict(save_every=1, saved_models_path=models)
    out = []
    for tag, entries in (
            ("conv", [p for p in conv if p["training_size"] == 200]),
            ("gob_cmp_njode", gob_nj), ("hwof", hwof), ("combined", comb),
            ("sine", sine)):
        for i, p in enumerate(entries):
            q = dict(p, base_data_path=data, **where)
            q.setdefault("training_size", SWEEP_TRAIN[p["batch_size"]])
            n = f"{tag}{width(p)}"
            out.append((n + (f"_{i}" if tag in ("hwof", "sine") else ""),
                        "njode", q))
    out.append(("gob_cmp_gob50", "gob", dict(
        gob_50[0], base_data_path=data, training_size=SWEEP_TRAIN[20],
        **where)))
    small = [p for p in clim if "other_model" not in p and width(p) == 50
             and p["data_index"] == 0]
    out.append(("climate50", "climate", dict(
        small[0], climate_dir=results["climate"]["dir"], **where)))
    p50 = [p for p in phys if width(p) == 50]
    out.append(("physionet50", "physionet", dict(
        p50[0], records=results["phys"]["records"][:PHYS_TRAIN_RECORDS],
        n_samples=PHYS_TRAIN_RECORDS, **where)))
    if len(out) != 15 or len(gob_nj) != 1 or len(gob_50) != 1:
        raise AssertionError(f"sweep: unexpected grid entries: "
                             f"{[t for t, _, _ in out]}")
    return out


def _sweep_njode_cfg(p, data):
    """The NJODE config a synthetic grid entry trains: its dataset's
    dimension, output = input."""
    from njode_tpu_torch.data import datasets
    from njode_tpu_torch.models.njode import NJODEConfig

    D = datasets.load_metadata(p["dataset"], p.get("dataset_id"),
                               data)["dimension"]
    return NJODEConfig(D, p["hidden_size"], D, p["ode_nn"], p["readout_nn"],
                       p["enc_nn"], dropout_rate=p["dropout_rate"])


def _sweep_expect(kind, p, cfg, results, chunks):
    """The exact launch counts of one epoch of an entry."""
    from njode_tpu_torch.ops import fused_scan as fs

    if kind == "njode":
        steps = p["training_size"] // p["batch_size"]
        g = "_global" if fs.Spec(cfg).plan == "global" else ""
        return {"njode_scan_fwd" + g: steps, "njode_scan_bwd" + g: steps,
                "njode_scan_eval" + g: 1, "philox_keep": 2 * steps,
                "reduce_partials": 2 * steps + 1}
    if kind == "gob":
        steps = p["training_size"] // p["batch_size"]
        return chunks.expect(steps, evals=1, reduce_extra=1)
    n = (results["climate"]["n_train"] if kind == "climate"
         else int(0.8 * p["n_samples"]))
    steps = -(-n // p["batch_size"])     # the real-data eval is eager
    return {"njode_scan_fwd": steps, "njode_scan_bwd": steps,
            "philox_keep": 2 * steps, "reduce_partials": 2 * steps}


def _sweep_run(results, tag, kind, p, data, models, draw):
    """One entry through ``sweeps.parallel_training``, with every count set
    to 0 just before and read just after, its trainer's output captured:
    the result must be 0, its metric row finite, its counts exact, every
    scan launch at the rule's rows, and its figures skipped with one line
    where matplotlib is missing (``draw`` False), else written."""
    import contextlib
    import io

    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import registry, sweeps, trainer
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    cfg = None
    if kind == "njode":
        cfg = _sweep_njode_cfg(p, data)
        plan = fs.Spec(cfg).plan
        if plan != ("global" if p["ode_nn"][0][0] in SWEEP_GLOBAL_WIDTHS
                    else "resident"):
            raise AssertionError(f"sweep {tag}: the rule takes the {plan} "
                                 "plan")
    elif kind in ("climate", "physionet"):
        D, H = (5, 10) if kind == "climate" else (41, 41)
        cfg = _masked_cfg(D, H, p["ode_nn"][0][0])
    log = io.StringIO()
    t0 = time.time()
    fs.reset_launch_counts()
    fg.reset_launch_counts()
    with BwdChunks() as chunks, contextlib.redirect_stdout(log):
        res = sweeps.parallel_training(params=[p])
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = dict(fs.LAUNCHES, **fg.LAUNCHES)
    text = log.getvalue()
    if res != [0]:
        print(text[-4000:], file=sys.stderr)
        raise AssertionError(f"sweep {tag}: result {res!r}, expected [0]")
    mid = registry.load_overview(models)[-1][0]
    cols, rows = read_frame(os.path.join(models, f"id-{mid}",
                                         f"metric_id-{mid}.csv"))
    if len(rows) != 1:
        raise AssertionError(f"sweep {tag}: {len(rows)} metric rows")
    rec = {k: to_float(v) for k, v in zip(cols, rows[0])}
    nan_ok = ("optimal_eval_loss",) if kind == "gob" else ()
    if not all(np.isfinite(v) for k, v in rec.items() if k not in nan_ok):
        raise AssertionError(f"sweep {tag}: non-finite metrics {rec}")
    _check_counts("sweep", counts,
                  _sweep_expect(kind, p, cfg, results, chunks))
    if cfg is not None:
        check_rows("sweep", cfg)
    plots = os.path.join(models, f"id-{mid}", "plots")
    n_figs = len(os.listdir(plots)) if os.path.isdir(plots) else 0
    if p.get("plot"):
        skipped = text.count(trainer.PLOT_SKIPPED)
        want_figs = len(p["paths_to_plot"]) if draw else 0
        if skipped != (0 if draw else 1) or n_figs != want_figs or \
                text.count("optimal eval-loss (with current weight=") != 1:
            raise AssertionError(f"sweep {tag}: {skipped} skip lines, "
                                 f"{n_figs} figures (matplotlib: {draw})")
    say("sweep", run=tag, id=mid, result=res[0], secs=f"{secs:.2f}",
        **{k: f"{v:.6f}" for k, v in rec.items() if k != "epoch"},
        figures=n_figs, plot_skip_line=trainer.PLOT_SKIPPED in text)
    return counts


def _sweep_shape_checks(results):
    """K1 and K2 (with K3) against their plain versions in 'input' mode,
    each twice bit for bit, at the North-star tolerances (``SHORT_TOL``),
    at every shape of ``SWEEP_SHAPES``; the largest errors of each plan go
    to ``results["sweep_errs"]``. For the timed shapes: their CUDA-event
    times and bounds ('prng') and the rows, CTAs and waves
    (``check_waves``)."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {p: {"K1m": 0.0, "K2m": 0.0, "K3m": 0.0}
             for p in ("resident", "global")}
    for arm, width, B, plan, data, timed_arm in SWEEP_SHAPES:
        cfg, model, batch = main_path_setup(B, 100, 3, dev, width=width,
                                            data=data)
        spec = fs.Spec(cfg)
        if (spec.plan, spec.rows_for(B), spec.rows_for(B, False)) != (
                plan[0], plan[1], plan[1]):
            raise AssertionError(f"sweep {arm}: plan {spec.plan} at "
                                 f"{spec.rows_for(B)} rows, expected {plan}")
        errs, _, _ = _masked_arm_checks(
            "sweep", cfg, model, batch, ((100, ("input",), SHORT_TOL),), gen,
            arm=arm, D=cfg.input_size)
        for k, v in errs.items():
            worst[plan[0]][k] = max(worst[plan[0]][k], v)
        if not timed_arm:
            continue
        ms, bd, K, Bt, spec_p = _full_grid_times(cfg, model, batch, 10)
        _say_times("sweep", arm, spec_p, ms, bd, K, Bt)
        check_waves("sweep", arm, cfg, B)
        if arm.startswith("conv"):
            ms, bd, K, Bt, spec_p = _full_grid_times(cfg, model, batch, 10,
                                                     plan=("global", 1))
            _say_times("sweep", arm + "_forced_1_row", spec_p, ms, bd, K,
                       Bt)
    say("sweep", shape_errs=json.dumps(worst).replace(" ", ""))
    results["sweep_errs"] = worst


def phase_sweep(results):
    """The published grids through the sweep runner on the card (the
    datasets at 20,000 paths, one epoch a run), then K1-K3 against their
    plain versions at every shape its unmasked runs take."""
    from njode_tpu_torch.training.plots import have_matplotlib

    tmp = tempfile.mkdtemp(prefix="njode_smoke_sweep_")
    try:
        data = os.path.join(tmp, "data")
        models = os.path.join(tmp, "models")
        draw = have_matplotlib()
        say("sweep", matplotlib=draw)
        launches = {"njode": {}, "masked": {}, "gob": {}}
        for tag, kind, p in sweep_entries(results, data, models):
            counts = _sweep_run(results, tag, kind, p, data, models, draw)
            group = {"njode": "njode", "gob": "gob"}.get(kind, "masked")
            for k, v in counts.items():
                launches[group][k] = launches[group].get(k, 0) + v
        results["sweep_launches"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _sweep_shape_checks(results)


# the groups phase: the member axis checked at E = 3, timed at E = 5
GROUP_CHECK_E, GROUP_TIME_E = 3, 5
GROUP_CONV_REPEATS, GROUP_CLIMATE_FOLDS, GROUP_PHYS_REPEATS = 5, 5, 2


def _member_layout(models, batches):
    """Each member's solo inputs (leaves, batch arrays, t=0 state) and
    the member layout of all of them (leaves [E, ...], arrays with a
    leading member axis but the shared grid, h0 [E, B, H])."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    solo = []
    for m, b in zip(models, batches):
        with torch.no_grad():
            h0 = fs.t0_state(m, b).contiguous()
        solo.append(([p.detach() for p in fs.flat_leaves(m)],
                     fs.batch_arrays(b), h0))
    leaves = [torch.stack(ls) for ls in zip(*(s[0] for s in solo))]
    arrays = tuple(solo[0][1][i] if i < 2 else
                   torch.stack([s[1][i] for s in solo]).contiguous()
                   for i in range(7))
    return solo, leaves, arrays, torch.stack([s[2] for s in solo])


def _member_draws(spec, E, K, B, mode, gen, dev):
    import torch
    if mode == "input":
        return (torch.rand((E, K, spec.S, B, spec.w_max), generator=gen,
                           device=dev) < 0.9).to(torch.int8), None
    return None, torch.randint(0, 2 ** 62, (E,), generator=gen, device=dev,
                               dtype=torch.int64)


def _member_check(arm, cfg, models, batches, gen, tol=SHORT_TOL,
                  K_plain=None):
    """K1 and K2 over a member axis (E members, each its own weights,
    batch and masks) in 'input' and 'prng' mode: twice bit for bit, each
    member bit for bit its own solo launches at the same rows, and within
    ``tol`` of the member plain version (over the first ``K_plain`` steps
    where given: the member launch run again on them). Returns the
    largest errors against the plain version."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = batches[0].obs.device
    E = len(models)
    solo, leaves, arrays, h0 = _member_layout(models, batches)
    _, K, B = arrays[2].shape
    errs = {"K1": 0.0, "K2": 0.0}
    for mode in ("input", "prng"):
        spec = fs.Spec(cfg, mode)
        u, seed = _member_draws(spec, E, K, B, mode, gen, dev)
        ones = torch.ones((E,), device=dev)
        fs.reset_launch_counts()
        outs = []
        for _ in range(2):
            lk, hk = fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.5, h0,
                                              True, u, seed)
            gk, dk = fs.scan_bwd_members_cuda(spec, leaves, arrays, 0.5,
                                              True, hk, ones, u, seed)
            outs.append([lk, *hk, *gk, dk])
        key = fs._launch_key(spec)
        if (fs.LAUNCHES["njode_scan_fwd_members" + key],
                fs.LAUNCHES["njode_scan_bwd_members" + key]) != (2, 2):
            raise AssertionError(f"groups {arm}: member launches "
                                 f"{fs.LAUNCHES}")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"groups {arm} ({mode}): the member "
                                 "launches differ between two runs")
        n_diff = 0
        for e, (lv, arr, h0e) in enumerate(solo):
            ue = None if u is None else u[e].contiguous()
            se = None if seed is None else seed[e:e + 1]
            ls, hs = fs.scan_fwd_cuda(spec, lv, arr, 0.5, h0e, True, ue, se)
            gs, ds = fs.scan_bwd_cuda(spec, lv, arr, 0.5, True, hs,
                                      ones[e], ue, se)
            n_diff += sum(not torch.equal(a[e], b) for a, b in zip(
                outs[0], [ls, *hs, *gs, ds]))
        if n_diff:
            raise AssertionError(f"groups {arm} ({mode}): {n_diff} member "
                                 "outputs differ from their solo launches")
        lk, hk, gk, dk = outs[0][0], outs[0][1:4], outs[0][4:-1], outs[0][-1]
        arr_p, u_p = arrays, u
        if K_plain is not None:
            # the first K_plain steps of every member (n_obs recounted)
            t, d, o, X, _, sx, M = arrays
            o = o[:, :K_plain].contiguous()
            arr_p = (t[:K_plain].contiguous(), d[:K_plain].contiguous(), o,
                     X[:, :K_plain].contiguous(), o.sum(dim=1), sx,
                     None if M is None else M[:, :K_plain].contiguous())
            u_p = None if u is None else u[:, :K_plain].contiguous()
            lk, hk = fs.scan_fwd_members_cuda(spec, leaves, arr_p, 0.5, h0,
                                              True, u_p, seed)
            gk, dk = fs.scan_bwd_members_cuda(spec, leaves, arr_p, 0.5, True,
                                              hk, ones, u_p, seed)
        (lp, hp), plain_fwd = timed(lambda: fs.scan_fwd_members_plain(
            spec, leaves, arr_p, 0.5, h0, True, u_p, seed))
        e1 = check_close(f"groups {arm} K1 loss ({mode})", lk, lp,
                         tol["loss"])
        eh = max(check_close(f"groups {arm} K1 {n} ({mode})", a, b,
                             tol["hist"] or scaled_tol(b))
                 for n, a, b in zip(("h", "lastX", "tau"), hk, hp))
        (gp, dp), plain_bwd = timed(lambda: fs.scan_bwd_members_plain(
            spec, leaves, arr_p, 0.5, True, hk, ones, u_p, seed))
        e2 = max(check_close(f"groups {arm} K2 grad {i} ({mode})", a, b,
                             tol["grad"] or scaled_tol(b))
                 for i, (a, b) in enumerate(zip(gk, gp)))
        ed = check_close(f"groups {arm} K2 dh0 ({mode})", dk, dp, GRAD_TOL)
        errs["K1"] = max(errs["K1"], e1)
        errs["K2"] = max(errs["K2"], e2, ed)
        say("groups", check=arm, E=E, B=B, K=K, K_plain=K_plain or K,
            mode=mode, plan=spec.plan, rows=spec.rows_for(B),
            bit_equal_to_solo=True, bitwise_repeat=True,
            K1_loss_err=f"{e1:.3e}", K1_hist_err=f"{eh:.3e}",
            K2_grad_err=f"{e2:.3e}", K2_dh0_err=f"{ed:.3e}",
            plain_fwd_ms=f"{plain_fwd:.1f}", plain_bwd_ms=f"{plain_bwd:.1f}")
    return errs


def _member_times(arm, cfg, models, batches, reps, plain=False):
    """CUDA-event ms of the member launch of K1 and K2 ('prng') for the E
    members against E solo launches one after another, the bounds (E
    times the solo bound: the same MACs and bytes a member), the rows,
    CTAs and the per-member ms; with ``plain`` the member plain version
    too (one run). Returns the dict of this arm's numbers."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = batches[0].obs.device
    E = len(models)
    solo, leaves, arrays, h0 = _member_layout(models, batches)
    _, K, B = arrays[2].shape
    spec = fs.Spec(cfg, "prng")
    seed = torch.arange(1, E + 1, dtype=torch.int64, device=dev) * 7919
    ones = torch.ones((E,), device=dev)
    _, hk = fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.5, h0, True,
                                     None, seed)
    hs = [fs.scan_fwd_cuda(spec, lv, arr, 0.5, h0e, True, None,
                           seed[e:e + 1])[1]
          for e, (lv, arr, h0e) in enumerate(solo)]

    def solo_fwd():
        for e, (lv, arr, h0e) in enumerate(solo):
            fs.scan_fwd_cuda(spec, lv, arr, 0.5, h0e, True, None,
                             seed[e:e + 1])

    def solo_bwd():
        for e, (lv, arr, h0e) in enumerate(solo):
            fs.scan_bwd_cuda(spec, lv, arr, 0.5, True, hs[e], ones[e], None,
                             seed[e:e + 1])

    t = {"K1": cuda_ms(lambda: fs.scan_fwd_members_cuda(
            spec, leaves, arrays, 0.5, h0, True, None, seed), reps, 1),
         "K2": cuda_ms(lambda: fs.scan_bwd_members_cuda(
            spec, leaves, arrays, 0.5, True, hk, ones, None, seed), reps, 1),
         "K1_solo": cuda_ms(solo_fwd, reps, 1),
         "K2_solo": cuda_ms(solo_bwd, reps, 1)}
    bd = _scan_bounds(spec, K, B)
    out = {"E": E, "B": B, "K": K, "spec": spec}
    for k in ("K1", "K2"):
        bms = E * bd[k][0]
        out[k] = dict(ms=t[k], solo_x_E_ms=t[k + "_solo"], bound_ms=bms,
                      bound_by=bd[k][1])
        say("groups", timing=arm, kernel=k + "_members", E=E, B=B, K=K,
            plan=spec.plan, rows=spec.rows_for(B, k == "K2"),
            ctas=E * -(-B // spec.rows_for(B, k == "K2")),
            ms=f"{t[k]:.4f}", ms_per_member=f"{t[k] / E:.4f}",
            solo_x_E_ms=f"{t[k + '_solo']:.4f}",
            solo_ms=f"{t[k + '_solo'] / E:.4f}",
            speedup=f"{t[k + '_solo'] / t[k]:.3f}",
            bound_ms=f"{bms:.6f}", bound_by=bd[k][1],
            roofline_share=f"{bms / t[k]:.2e}")
    if plain:
        (_, hp), out["K1"]["plain_ms"] = timed(
            lambda: fs.scan_fwd_members_plain(spec, leaves, arrays, 0.5, h0,
                                              True, None, seed))
        _, out["K2"]["plain_ms"] = timed(lambda: fs.scan_bwd_members_plain(
            spec, leaves, arrays, 0.5, True, hk, ones, None, seed))
        say("groups", timing=arm, plain_K1_ms=f"{out['K1']['plain_ms']:.1f}",
            plain_K2_ms=f"{out['K2']['plain_ms']:.1f}")
    return out


def _synthetic_members(E, B, K, width, use_rnn=False, seed0=0):
    """E main-path-shaped models (three 2 x ``width`` MLPs) and E
    BlackScholes batches on the card, each its own seed."""
    out = [main_path_setup(B, K, seed0 + e, "cuda", use_rnn=use_rnn,
                           width=width) for e in range(E)]
    return out[0][0], [o[1] for o in out], [o[2] for o in out]


def _bank_members(E, setup, D, H, width, B, seed0=0):
    """E masked models at (D, H, width) and E batches of epoch 1 of the
    real-data bank ``setup`` (the climate or PhysioNet stand-in)."""
    import torch

    from njode_tpu_torch.training import climate_trainer as ct
    from njode_tpu_torch.training.steps import prestacked_batch

    bank, times, dts, n_train = setup["bank"]
    idx_mat, _, _ = ct.epoch_batches(398, 1, n_train, B)
    batches = [prestacked_batch(*bank, torch.as_tensor(
        idx_mat[e], device=times.device), times, dts) for e in range(E)]
    models = [_masked_njode(D, H, width, "cuda", seed=seed0 + e)[1]
              for e in range(E)]
    return _masked_cfg(D, H, width), models, batches


def _member_reduce_times(E, n_parts, n):
    """The member reduce_partials at [E, n_parts, n]: bit for bit its plain
    version and E solo reductions, twice; device ms (``queued_ms``) beside
    E solo launches' and ``sum(dim=1)``'s, the plain version's CUDA-event
    ms, the bound (its bytes; the partials, 20 MB at the main path's
    shape, stay in the 50 MB L2 between calls, so the time can beat it)."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    gen = torch.Generator(device="cuda").manual_seed(21)
    P = torch.randn((E, n_parts, n), generator=gen, device="cuda")
    r1 = fs.reduce_partials_members_cuda(P)
    r2 = fs.reduce_partials_members_cuda(P)
    torch.cuda.synchronize()
    if not (torch.equal(r1, r2)
            and torch.equal(r1, fs.reduce_partials_members_plain(P))
            and all(torch.equal(r1[e], fs.reduce_partials_cuda(P[e]))
                    for e in range(E))):
        raise AssertionError(f"reduce_partials_members [{E},{n_parts},{n}] "
                             "differs from its plain version")
    # device ms from CUDA events around calls queued behind a device sleep
    # (queued_ms): torch.profiler lost records of these calls (a per-call
    # average of 0.38 us, below the 6 us bound)
    dev_ms = queued_ms(lambda: fs.reduce_partials_members_cuda(P))
    solo_ms = queued_ms(lambda: [fs.reduce_partials_cuda(P[e])
                                 for e in range(E)])
    lib_ms = queued_ms(lambda: P.sum(dim=1))
    plain = cuda_ms(lambda: fs.reduce_partials_members_plain(P), 5, 1)
    bms, by = bound(float(E * n_parts * n), 4.0 * E * (n_parts + 1) * n,
                    PEAK_FP32)
    say("groups", timing="reduce_partials_members",
        shape=f"[{E},{n_parts},{n}]", bit_equal=True,
        queued_ms=f"{dev_ms:.5f}", solo_x_E_queued_ms=f"{solo_ms:.5f}",
        library_queued_ms=f"{lib_ms:.5f}", plain_ms=f"{plain:.4f}",
        bound_ms=f"{bms:.6f}", bound_by=by,
        roofline_share=f"{bms / dev_ms:.2e}")
    return dict(ms=dev_ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)


def _group_run(tag, entries, expect, cfg, models_dir):
    """``entries`` through ``sweeps.parallel_training(vmap_groups=True)``,
    every count set to 0 just before and read just after: every result 0,
    each member's metric row finite, the counts exact (a group that fell
    back to solo runs launches no member kernel and fails here), every
    scan launch at the rule's rows. Returns (counts, seconds, rows)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import registry, sweeps
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    log = io.StringIO()
    t0 = time.time()
    fs.reset_launch_counts()
    with contextlib.redirect_stdout(log):
        res = sweeps.parallel_training(params=entries, vmap_groups=True)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = dict(fs.LAUNCHES)
    if res != [0] * len(entries):
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise AssertionError(f"groups {tag}: results {res!r}")
    if "group: " not in log.getvalue():
        raise AssertionError(f"groups {tag}: the entries did not group")
    ids = [r[0] for r in registry.load_overview(models_dir)][-len(entries):]
    rows = []
    for mid in ids:
        cols, rs = read_frame(os.path.join(models_dir, f"id-{mid}",
                                           f"metric_id-{mid}.csv"))
        rec = {k: to_float(v) for k, v in zip(cols, rs[-1])}
        if len(rs) != 1 or not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"groups {tag}: id {mid} rows {rs}")
        rows.append(rec)
    _check_counts("groups", counts, expect)
    check_rows("groups", cfg)
    say("groups", run=tag, members=len(entries), secs=f"{secs:.2f}",
        train_time_per_member=f"{rows[0]['train_time']:.4f}",
        eval_time_per_member=f"{rows[0]['eval_time']:.4f}",
        train_loss=",".join(f"{r['train_loss']:.6f}" for r in rows))
    return counts, secs, ids


def phase_groups(results):
    """The grouped ensembles: the member axis of K1/K2 checked (E = 3, bit
    for bit E solo launches and within the North-star tolerances of the
    member plain version) at the main path, the convergence study's width
    320 (global / 8), the climate small arm (masked, K = 2,004; the plain
    version over the first 100 steps), the PhysioNet 50 arm (masked,
    B = 50, K = 3,006; the same) and the main path with the GRU jump; timed at E = 5 against five solo launches at widths 320 and 40
    (B = 20), the main path (B = 100) and the PhysioNet 50 arm (B = 50,
    K = 3,006); the member reduce_partials; then three group trainers
    through ``parallel_training(vmap_groups=True)``, one epoch each: a
    convergence cell (width 320, 5 repeats), the climate small arm's 5
    folds, the PhysioNet 50 arm x 2 repeats; one convergence member's row
    against a solo run of its params, bit for bit."""
    import contextlib
    import io

    import numpy as np
    import torch

    from njode_tpu_torch.experiments import configs
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import registry, sweeps
    from njode_tpu_torch.utils.csv_frame import read_frame

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(12)
    E = GROUP_CHECK_E
    errs = {"K1": 0.0, "K2": 0.0}
    checks = (
        ("main", _synthetic_members(E, 100, 100, 50), {}),
        ("conv320", _synthetic_members(E, 20, 100, 320), {}),
        ("climate50", _bank_members(E, results["climate"], 5, 10, 50,
                                    CLIMATE_B),
         dict(tol=LONG_TOL, K_plain=100)),
        ("phys50", _bank_members(E, results["phys"], 41, 41, 50, PHYS_B),
         dict(tol=LONG_TOL, K_plain=100)),
        ("main_rnn", _synthetic_members(E, 100, 100, 50, use_rnn=True), {}))
    for arm, (cfg, models, batches), kw in checks:
        spec = fs.Spec(cfg)
        if arm == "conv320" and (spec.plan, spec.rows_for(20)) != (
                "global", 8):
            raise AssertionError(f"groups conv320: {spec.plan} / "
                                 f"{spec.rows_for(20)}")
        e = _member_check(arm, cfg, models, batches, gen, **kw)
        for k in errs:
            errs[k] = max(errs[k], e[k])
    say("groups", checks_s=f"{time.time() - t0:.2f}")
    t1 = time.time()
    E = GROUP_TIME_E
    times = {}
    for arm, members, reps, plain in (
            ("conv320", _synthetic_members(E, 20, 100, 320, seed0=3), 3,
             False),
            ("conv40", _synthetic_members(E, 20, 100, 40, seed0=3), 10,
             False),
            ("main", _synthetic_members(E, 100, 100, 50, seed0=3), 10, True),
            ("phys50", _bank_members(E, results["phys"], 41, 41, 50, PHYS_B),
             2, False)):
        times[arm] = _member_times(arm, *members, reps, plain)
    spec = times["main"]["spec"]
    red = _member_reduce_times(E, -(-100 // spec.rows_for(100)),
                               spec.n_params)
    say("groups", timings_s=f"{time.time() - t1:.2f}")

    tmp = tempfile.mkdtemp(prefix="njode_smoke_groups_")
    launches = {}
    try:
        data = os.path.join(tmp, "data")
        models = os.path.join(tmp, "models")
        configs.ensure_base_datasets(base_path=data)
        where = dict(saved_models_path=models, base_data_path=data)
        conv, _ = configs.convergence_study(epochs=1,
                                            repeats=GROUP_CONV_REPEATS,
                                            saved_models_path=models)
        conv = [dict(p, **where) for p in conv
                if p["ode_nn"][0][0] == 320 and p["training_size"] == 200]
        steps = 200 // 20
        E = len(conv)
        solo_entry = dict(conv[2])
        cfg = _sweep_njode_cfg(conv[0], data)
        counts, _, ids = _group_run("conv320", conv, {
            "njode_scan_fwd_members_global": steps,
            "njode_scan_bwd_members_global": steps,
            "philox_keep_members": 2 * steps,
            "reduce_partials_members": 2 * steps,
            "njode_scan_eval_global": E, "reduce_partials": E}, cfg, models)
        launches["conv320"] = counts
        # member 2 against its solo run
        solo_models = os.path.join(tmp, "solo")
        fs.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            solo_res = sweeps.parallel_training(params=[dict(
                solo_entry, saved_models_path=solo_models)])
        if solo_res != [0]:
            raise AssertionError("groups: the solo conv320 run failed")
        cols, rg = read_frame(os.path.join(models, f"id-{ids[2]}",
                                           f"metric_id-{ids[2]}.csv"))
        mid = registry.load_overview(solo_models)[-1][0]
        _, rs = read_frame(os.path.join(solo_models, f"id-{mid}",
                                        f"metric_id-{mid}.csv"))
        keep = [i for i, c in enumerate(cols)
                if c not in ("train_time", "eval_time")]
        same = [rg[0][i] for i in keep] == [rs[0][i] for i in keep]
        say("groups", member_vs_solo="conv320 member 2",
            columns=",".join(cols[i] for i in keep), bit_equal=same)
        if not same:
            raise AssertionError(f"groups: member row {rg[0]} differs from "
                                 f"the solo run's {rs[0]}")

        clim, _ = configs.climate_cross_validation(epochs=1)
        clim = [dict(p, climate_dir=results["climate"]["dir"],
                     saved_models_path=models) for p in clim
                if "other_model" not in p and p["ode_nn"][0][0] == 50
                and p["data_index"] < GROUP_CLIMATE_FOLDS]
        n_tr = [len(np.load(os.path.join(
            results["climate"]["dir"], f"small_chunk_fold_idx_{f}",
            "train_idx.npy"))) for f in range(GROUP_CLIMATE_FOLDS)]
        steps = max(-(-n // CLIMATE_B) for n in n_tr)
        counts, _, _ = _group_run("climate50", clim, {
            "njode_scan_fwd_members": steps,
            "njode_scan_bwd_members": steps,
            "philox_keep_members": 2 * steps,
            "reduce_partials_members": 2 * steps},
            _masked_cfg(5, 10, 50), models)
        launches["climate50"] = counts

        recs = results["phys"]["records"][:PHYS_TRAIN_RECORDS]
        phys, _ = configs.physionet_comparison(
            epochs=1, repeats=GROUP_PHYS_REPEATS, saved_models_path=models)
        phys = [dict(p, records=recs, n_samples=PHYS_TRAIN_RECORDS)
                for p in phys if p["ode_nn"][0][0] == 50]
        steps = -(-int(0.8 * PHYS_TRAIN_RECORDS) // PHYS_B)
        counts, _, _ = _group_run("phys50", phys, {
            "njode_scan_fwd_members": steps,
            "njode_scan_bwd_members": steps,
            "philox_keep_members": 2 * steps,
            "reduce_partials_members": 2 * steps},
            _masked_cfg(41, 41, 50), models)
        launches["phys50"] = counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["groups"] = dict(errs=errs, times=times, reduce=red,
                             launches=launches)


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
    # the sweep's runs: unmasked NJODE (both plans), masked NJODE (climate,
    # PhysioNet) and GRU-ODE-Bayes
    sn, sm, sg = (results["sweep_launches"][k]
                  for k in ("njode", "masked", "gob"))
    # the sweep's unmasked shapes, checked in _sweep_shape_checks
    se = results["sweep_errs"]
    # GOB: the per-epoch and the chunked trainer runs, and the sweep's
    gl = {k: v + results["gob_chunk_launches"][k] + sg.get(k, 0)
          for k, v in results["gob_launches"].items()}
    cn, cg = (results["climate_launches"][k] for k in ("njode", "gob"))
    pl, pr = results["phys_launches"], results["phys_rnn"]["launches"]
    p2 = results["phys200_launches"]
    rl, cr = results["rnn_launches"], results["climate_rnn"]["launches"]
    for name, key, replaces, count in rows:
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        # the main path: the per-epoch and chunked trainer runs, the bench
        launches = sum(results[r][count] for r in (
            "launches", "chunk_launches", "bench_launches"))
        if name == "reduce_partials":    # runs on every path
            launches += sum(c["reduce_partials"]
                            for c in (gl, cn, cg, pl, p2, rl, cr, pr, sn, sm))
        elif name == "philox_keep":      # the NJODE paths
            launches += sum(c["philox_keep"]
                            for c in (cn, pl, p2, rl, cr, pr, sn, sm))
        else:
            launches += sn[count]
        err = results["errs"][key]
        if key in ("K1", "K2", "K3"):
            err = max(err, se["resident"][key + "m"])
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": results["library_ms"].get(key)})
    # GRU-ODE-Bayes at the trainer's widths: K5, its eval form, K6 as a
    # whole (ms of a call, its three stages included; launches: stage (b)'s,
    # one a chunk) and each of K6's stages (device ms per call; launches
    # from the synthetic and the climate GOB trainers), K7
    gsrc = "njode_tpu_torch/ops/csrc/fused_gob.cu"
    ge = results["gob_errs"]
    k6 = "njode_tpu/ops/fused_gob.py:963"
    for name, key, replaces, launches, err in (
            ("gob_scan_fwd", "K5", "njode_tpu/ops/fused_gob.py:919",
             gl["gob_scan_fwd"], ge["K5"]),
            ("gob_scan_eval", "K5e", "njode_tpu/ops/fused_gob.py:718",
             gl["gob_scan_eval"], ge["K5e"]),
            ("gob_scan_bwd", "K6", k6, gl["gob_scan_bwd"], ge["K6"]),
            ("gob_bwd_remat", "K6remat", k6,
             gl["gob_bwd_remat"] + cg["gob_bwd_remat"], ge["remat"]),
            ("gob_bwd_chain", "K6chain", k6,
             gl["gob_scan_bwd"] + cg["gob_scan_bwd"], ge["chain"]),
            ("gob_bwd_wgrad", "K6wgrad", k6,
             gl["gob_bwd_wgrad"] + cg["gob_bwd_wgrad"], ge["wgrad"]),
            ("gob_philox_keep", "K7", "njode_tpu/ops/fused_gob.py:700",
             gl["gob_philox_keep"], ge["K7"])):
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        out.append({"name": name, "route": "cuda",
                    "source": gsrc if key != "K7"
                    else "njode_tpu_torch/ops/csrc/philox.cuh",
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": results["library_ms"].get(key)})
    # the climate path: the masked branch of K1-K3, K5/K6 at the climate
    # GRU-ODE-Bayes arm (launches from the climate trainer phase and, for
    # the masked branch, the PhysioNet one, whose 50 arm runs it in the
    # resident plan, one row a CTA)
    ce = results["climate_errs"]
    for name, key, s, replaces, launches in (
            ("njode_scan_fwd_masked", "K1m", src,
             "njode_tpu/ops/fused_scan.py:695",
             cn["njode_scan_fwd"] + pl["njode_scan_fwd"]
             + sm["njode_scan_fwd"]),
            ("njode_scan_bwd_masked", "K2m", src,
             "njode_tpu/ops/fused_scan.py:772",
             cn["njode_scan_bwd"] + pl["njode_scan_bwd"]
             + sm["njode_scan_bwd"]),
            ("njode_scan_eval_masked", "K3m", src,
             "njode_tpu/ops/fused_scan.py:695", cn["njode_scan_eval"]),
            ("gob_scan_fwd_climate", "K5c", gsrc,
             "njode_tpu/ops/fused_gob.py:919", cg["gob_scan_fwd"]),
            ("gob_scan_bwd_climate", "K6c", gsrc,
             "njode_tpu/ops/fused_gob.py:963", cg["gob_scan_bwd"])):
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        out.append({"name": name, "route": "cuda", "source": s,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": ce[key], "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the global plan of K1-K3 with the encoder jump (the JAX kernel's
    # blocked plan for nets that overflow VMEM), timed at the PhysioNet 50
    # arm forced into it; launches from the 200 arm's epoch and the sweep,
    # errors the largest of the physionet_kernels and the sweep's checks
    pe = results["phys"]["errs"]
    for name, key, replaces in (
            ("njode_scan_fwd_global", "K1",
             "njode_tpu/ops/fused_scan.py:431"),
            ("njode_scan_bwd_global", "K2",
             "njode_tpu/ops/fused_scan.py:1164"),
            ("njode_scan_eval_global", "K3",
             "njode_tpu/ops/fused_scan.py:1278")):
        ms, plain = results["times"][key + "g"]
        bms, by = results["bounds"][key + "g"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": p2[name] + sn[name],
                    "max_abs_err": max(pe[key + "m"],
                                       se["global"][key + "m"]),
                    "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the GRU jump (use_rnn) of K1-K3, timed at the main path; launches
    # from its trainer phase, the climate one and the PhysioNet one (the
    # global plan), errors the largest of its checks at the main path, the
    # climate small arm and phys50
    rerrs = [results["rnn"]["errs"], results["climate_rnn"]["errs"],
             results["phys_rnn"]["errs"]]
    err = {k: max(e[k + "m"] for e in rerrs) for k in ("K1", "K2", "K3")}
    err["K3"] = max(err["K3"], rerrs[0]["K3"])
    for name, key, replaces in (
            ("njode_scan_fwd_rnn", "K1", "njode_tpu/ops/fused_scan.py:594"),
            ("njode_scan_bwd_rnn", "K2", "njode_tpu/ops/fused_scan.py:605"),
            ("njode_scan_eval_rnn", "K3",
             "njode_tpu/ops/fused_scan.py:718")):
        ms, plain = results["times"][key + "r"]
        bms, by = results["bounds"][key + "r"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": rl[name] + cr[name] + pr[name + "_global"],
                    "max_abs_err": err[key], "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    # K1/K2 over a member axis and the member reduce_partials (the groups
    # phase): timed at the main path at E = 5 (B = 100), launches from its
    # group trainers (both plans), errors the largest of its E = 3 checks
    g = results["groups"]
    gm = g["times"]["main"]
    member_launches = {}
    for counts in g["launches"].values():
        for k, v in counts.items():
            member_launches[k] = member_launches.get(k, 0) + v
    for name, key, replaces in (
            ("njode_scan_fwd_members", "K1",
             "njode_tpu/ops/fused_scan.py:1115"),
            ("njode_scan_bwd_members", "K2",
             "njode_tpu/ops/fused_scan.py:1164")):
        launches = sum(v for k, v in member_launches.items()
                       if k.startswith(name))
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": g["errs"][key], "ms": gm[key]["ms"],
                    "plain_ms": gm[key]["plain_ms"],
                    "bound_ms": gm[key]["bound_ms"],
                    "bound_by": gm[key]["bound_by"], "library_ms": None})
    r = g["reduce"]
    out.append({"name": "reduce_partials_members", "route": "cuda",
                "source": src, "replaces": "njode_tpu/ops/fused_scan.py:522",
                "launches": member_launches["reduce_partials_members"],
                "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
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
    from njode_tpu_torch.bench import card_line
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
                  phase_rnn_kernels, phase_rnn_timing,
                  phase_gob_kernels, phase_gob_timing, phase_gob_trainer,
                  phase_sync, phase_busy, phase_bench):
        phase(results)
        say(phase.__name__[6:], phase_s=f"{time.time() - t0:.2f}")
        t0 = time.time()
    # the climate stand-in stays on disk for the sweep's climate run
    tmp = tempfile.mkdtemp(prefix="njode_smoke_climate_")
    try:
        climate_setup(results, tmp)
        t0 = time.time()
        for phase in (phase_climate_kernels, phase_climate_timing,
                      phase_climate_trainer, phase_climate_rnn):
            phase(results)
            say(phase.__name__[6:], phase_s=f"{time.time() - t0:.2f}")
            t0 = time.time()
        physionet_setup(results)
        t0 = time.time()
        for phase in (phase_physionet_kernels, phase_physionet_timing,
                      phase_physionet_trainer, phase_physionet_rnn,
                      phase_sweep, phase_groups):
            phase(results)
            say(phase.__name__[6:], phase_s=f"{time.time() - t0:.2f}")
            t0 = time.time()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(kernels_line(results), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
