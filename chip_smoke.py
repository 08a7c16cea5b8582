"""On-card smoke test of the PyTorch/CUDA port (njode_tpu_torch) on one H100.

    python3 chip_smoke.py            # every phase, one card, no arguments

Phases, one line each, then the ``kernels`` JSON line, the card's name and
power limit, and the final ``{"ok": true, ...}`` line. The set-ups of
phases 14 and 18, phases 26 and 28 and the tensor-parallel part of phase
31, which launch none of the kernels, run first, while nvcc builds them
(phase 2); phase 27 runs right after the build, with the host idle,
before phase 3:

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
4b. k2_stages - K2's three stages (stage (a) the forward re-run, stage
              (b) the chain, stage (c) the weight gradients; one C call)
              against their plain versions (fused_scan.
              scan_bwd_staged_plain): the call twice bit for bit, the
              workspace of its first chunk field by field (stage (a)'s
              forward fields, the chain's deltas) and the gradients, at
              the main path (B = 100, 200), the GRU jump, the climate small
              and PhysioNet 50 arms (their first 100 steps), an output of
              another width (the global plan), ODE nets of 9 and 16
              linears and E = 3 members (each its solo call's bits); each
              stage's device time at B = 200 (torch.profiler, summing to
              the call's CUDA-event time), its plain version's, its bound
              and stage (c)'s PyTorch yardstick; the workspace's bytes;
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
              0.1) over the first 100 steps in both mask modes and over the
              first 501 of the 2,004 steps in 'prng' mode, and K5/K6 at
              the GRU-ODE-Bayes climate arm (D 5, hidden 50, p_hidden 25,
              prep_hidden 10, cov_hidden 50, full field, impute off,
              logvar, mixing 1e-4, dropout 0.2) over the first 100 steps
              in both mask modes and over the first 501 in 'prng' mode;
              each kernel run twice and compared bit for bit;
15. climate_timing - CUDA-event times and bounds of the masked K1/K2/K3
              and of K5/K6 at the climate arms, B = 100, over all K = 2,004
              steps (the trainer's shape) and over the first 501 (beside
              the plain versions' times there), and the masks' cost inside
              K1/K2 and K5/K6 at K = 2,004 (``mask_cost``);
16. climate_trainer - climate_trainer.train on the stand-in, fold 0, one
              epoch of batch 100, the NJODE small arm and then the
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
              over the first 100 steps in both mask modes and over the
              first 501 of its 3,006 in 'prng' mode, step by step
              (``STEP_TOL``), the 200
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
              'prng', the resident plan, one row a CTA) for one epoch on
              the stand-in cut to 1,000 records (800 train, 16 batches);
              losses and both metrics finite, and the launch counts
              exact;
22. physionet_rnn - the masked GRU jump at the 50 arm in the resident
              plan (4 rows the most that fit, one a CTA at B = 50): K1-K3
              against their plain versions over the first 100 steps in
              both modes, their times and bounds over all 3,006, and one
              epoch of physionet_trainer.train(use_rnn=True) with exact
              launch counts;
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
              plan it takes (the global plan at widths 160, 320 and
              400), every scan launch at the rule's rows, and, where
              matplotlib is missing, its figures skipped with one printed
              line and none written; then K1 and K2 (with K3) against
              their plain versions in 'input' mode, each twice bit for
              bit, at the sine 400 arm's shape (B = 100, global / 4) and
              widths 320 and 160 at B = 20 (global / 8 and 16), with their
              CUDA-event times, bounds, rows, CTAs and waves;
24. groups   - the grouped ensembles (training/group_sweep.py,
              climate_group.py, physionet_group.py): K1 and K2 over a
              member axis (one launch of grid (ceil(B/R), E) for E
              members) at E = 3, in both mask modes, each member bit for
              bit its own solo launches at the same rows and the member
              launch twice bit for bit, and within the North-star
              tolerances of the member plain version over the first 25
              steps (the member launch run again on them), at the main
              path (B = 100), the convergence study's width 320 (global /
              8, B = 20), the climate small arm (B = 100, K = 2,004,
              LONG_TOL), the PhysioNet 50 arm (B = 50, K = 3,006) and the
              main path with the GRU jump; the member launch of K1/K2 at
              E = 5 timed against five solo launches (CUDA events) at
              widths 320 and 40 (B = 20), the main path (B = 100) and the
              PhysioNet 50 arm (B = 50, K = 3,006), with E times the solo
              bound; the member reduce_partials bit for bit its plain
              version and timed (device time) beside five solo launches
              and sum(dim=1); then sweeps.parallel_training(
              vmap_groups=True), one epoch each: a convergence cell
              (width 320, training size 200, B = 20, 5 repeats), the
              climate small arm's folds 0 and 1 on the stand-in, the
              PhysioNet 50 arm x 2 repeats on 1,000 records; every result
              0, every member's row finite, the launch counts exact (one
              member launch of K1 and of K2 a step: a group that fell back
              to solo runs fails them), and one convergence member's
              metric row bit for bit a solo run of its params;
25. parallel - data parallelism over torch.distributed
              (njode_tpu_torch/parallel/): NCCL at world size 1 in this
              process, an epoch of the main path (20,000 BlackScholes
              paths, B = 100, 'prng') through trainer.train(mesh=...) bit
              for bit the run without a mesh (every metric but the times,
              both checkpoints' tensors), its launch counts exact; then
              two gloo ranks sharing the card (NCCL refuses two ranks on
              one device), spawned with the kernels already built: one
              training step of the main path (B = 100, 50 rows a rank)
              and of the GOB trainer's widths (B = 20, 10 a rank) in
              'input' mode against the kernels without a mesh, at the
              North-star tolerances; an epoch of the main path, one GOB
              epoch (4,000 training paths), one epoch of the climate small
              arm (its validation and test batches padded to an even
              count), each with exact launch counts a rank at the rule's
              rows for 50 rows and the parameters equal to rank 0's bit
              for bit; the convergence cell (width 320) of 3 repeats over
              the two ranks (one ghost member), every member's row and
              checkpoints bit for bit the 1-rank group's; then K1/K2 at 50
              rows and K5/K6 at 10, one rank's launches, timed alone on
              the card beside their plain versions and bounds. Two ranks
              on one card measure no speed.
26. seq_gob  - the sequential GRU-ODE-Bayes (models/gru_ode_bayes.py
              SeqGOB, eager: it reaches no kernel) at the climate GOB arm's
              widths (D 5, hidden 50, p_hidden 25, prep_hidden 10,
              cov_hidden 50, full field, mixing 1e-4) on the first climate
              batch (B = 100, K = 2,004) with seeded covariates: one
              forward and backward on the card, timed, finite, and held to
              the same run on the CPU;
27. native   - the climate and PhysioNet set-up at the published scale
              (the pre-stacked banks, the test splits, an epoch of climate
              batches) with its union grids from the C++ collation
              (njode_tpu_torch/native, built with g++) and from numpy, the
              port's path: bit for bit, two runs each way, the seconds of
              each, and one batch's scatter bit for bit;
28. mixed_precision - compute_dtype='bfloat16': the bf16 product on the
              card (torch.mm with out_dtype=float32: bf16 operands on the
              tensor cores, fp32 result) against its plain form on the CPU,
              one bf16 step's gradients at the bench shape against the CPU
              with the card's rounding (BF16_GRAD_TOL, which the CPU route
              and fp32 fail), then experiments/mixed_precision_study.py's
              three shapes,
              3 steps each way: no kernel launch, the bf16 loss within
              2e-2 relative of the fp32 one, the route printed;
29. width_scaling - the width study's model (hidden 50, widths 50, 100,
              200, 400) on its own draws: one epoch of 2,000 paths at
              B = 200 with exact launch counts at the rule's rows, then
              K1/K2 (and K3) at each width's shape against their plain
              versions ('input', SHORT_TOL, each twice bit for bit) with
              their times and bounds;
30. profiling - the main path's trainer with profile_dir (the Chrome trace
              must hold one K1 and one K2 a step of the epoch) and with
              anomaly_detection (exact launch counts, anomaly mode off
              after it), then a step of the kernels with a NaN weight under
              anomaly detection, which must raise;
31. tp       - (runs right after parallel; its tensor-parallel part,
              tp_eager, while nvcc builds) the entry points and tensor
              parallelism (njode_tpu_torch/entry.py, parallel/
              tensor_parallel.py): entry()'s flagship loss on the card
              (B = 200, K = 100, 'prng'), finite, exactly one K1 launch;
              dryrun_multichip(2) over two gloo ranks sharing the card
              (each part of __graft_entry__.dryrun_multichip at its tiny
              shapes and tolerances, rank 0's launches exact: the masked
              K1/K2 twice, K3 once); then the main path's model (hidden
              10, three 2x50 tanh MLPs, dropout 0.1, B = 100, K = 100) cut
              over the 'model' axis of a 1 x 2 mesh of two gloo ranks on
              the card, on the eager forward (as the JAX package's tensor
              parallelism runs its XLA scan): the eval loss within 1e-5
              relative of the unsharded eager run, one Adam step's loss
              within 1e-4, its gathered gradients at rtol 2e-4 / atol 2e-5
              and parameters at rtol 1e-4 / atol 1e-6, the two ranks'
              parameters equal bit for bit (the dry run holds its 1-vs-n
              and DP x TP gradients at rtol 2e-4 / atol 2e-5 too); the ms of
              an eval and a step, sharded and not, beside nvcc. Two ranks
              on one card measure no speed;
32. scope    - (after width_scaling) the kernels' full scope: the main
              path's model with an ODE net of 9, 16, 33 and 65 linears
              (width 50), one trainer epoch each (1,000 paths, B = 100)
              with exact launch counts, and of 101 linears (width 10; the
              resident plan), one training step and one eval through the
              fused loss and eval functions with exact launch counts;
              then K1-K3 against their plain versions (each twice bit for
              bit), every arm timed; an unmasked output of another
              width than the input (HestonWOFeller return_vol, D = 2, with
              O = 1; BlackScholes, D = 1, with O = 2; the encoder and the
              GRU jump; the global plan, the only one such a config has,
              at 16 rows and at one) through the fused loss and eval
              functions with exact launch counts, K1-K3 against their plain
              versions; GOB at p_hidden 4,000 (hidden 10, prep 10), whose
              buffers of one row overflow a CTA, in the device-memory form:
              one trainer epoch (400 paths, B = 20) with exact launch
              counts, K5, its eval form and K6 against their plain versions
              and timed, K6's stages by device time (at least 90 % of
              their records, their sum within 0.8-1.05 of K6's CUDA-event
              time); and that
              form forced at hidden 50, bit for bit the shared form.

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
atol scaled by its own largest |value|. Over the first 501 of the
climate grid's 2,004 steps the masked kernels are held to ``LONG_TOL``
(see there), and over the first 501 of the PhysioNet grid's 3,006 step by
step (``STEP_TOL``). The two plans sum
in the same order, so at one row count they must agree bit for bit.
"""

from __future__ import annotations

import contextlib
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
# bf16 gradients of one eager step at the study's bench shape, card against
# the CPU with the card's rounding (bf16_grad_check), as the relative L2
# norm of the flat gradient; the loss is held to it too. Leaving the
# cotangent unrounded (the CPU route) moves the gradients by 3.3e-4 and
# float32 products by 2.5e-3, so both fail this bound; an H100 sits at
# 2.5e-5 (loss 1.1e-5): its float32 sums and transcendentals differ from
# the CPU's by ulps, and an ulp can flip a bf16-rounded operand by 2^-8.
BF16_GRAD_TOL = 1e-4
CLIMATE_SERIES = 1114      # the published scale of the USHCN file
CLIMATE_B = 100
# the climate kernels' long checks against the plain versions over the
# first quarter of the grid's 2,004 steps, 'prng' mode (all of them until
# the script's time ran short); their times over all 2,004
CLIMATE_CHECK_K = 501
# PhysioNet (experiments/configs.py physionet_comparison): set-a + set-b at
# n_samples 8,000, quantization 0.016 h, batch 50; the trainer phase's cut
PHYS_RECORDS = 8000
PHYS_QUANT = 0.016
PHYS_T = 1 + 1e-12
PHYS_B = 50
PHYS_TRAIN_RECORDS = 1000
PHYS_200_RECORDS = 400     # the stand-in cut for the 200 arm's one epoch
# the 50 arm's 'prng' check step by step over the first sixth of the
# grid's 3,006 steps (all of them until the script's time ran short)
PHYS_STEPWISE_K = 501
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
                    data=("BlackScholes", {}), hidden=10, ode_nn=None,
                    output_size=None):
    """Main-path model (with the GRU jump: ``use_rnn``; three 2 x ``width``
    tanh MLPs, the ODE net ``ode_nn`` where given; hidden size ``hidden``;
    input = output = the dataset's dimension D, the output ``output_size``
    where given) and a batch of
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
    cfg = NJODEConfig(D, hidden, output_size or D, ode_nn or nn_desc,
                      nn_desc, nn_desc, dropout_rate=0.1, use_rnn=use_rnn)
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
    # K1's own reading of its last (timed) launch: walk, threads a CTA and
    # the phases a step it ran
    results["k1_walk"] = k1_probe_check(
        "timing", spec, fs.make_cfg(spec, K, B, True, w, bwd=False))
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
    say("timing", kernel="K1", B=B, **results["k1_walk"])
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
    b2 = in_bytes + hist_bytes + 4 + 4 * P + 4 * B * spec.H
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


def _profiled(fn, names, reps, warm=False):
    """``{name: (device us, records)}`` of the kernels whose name holds
    each of ``names`` (None: every kernel) over ``reps`` calls of ``fn``
    in one ``torch.profiler`` run; with ``warm``, the capture opens with
    ``utils.profiling``'s launches, after which CUPTI has not been seen
    to lose a record (its ``trace``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from njode_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if warm:
            profiling._warm_up()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: [0.0, 0] for n in names}
    for ev in prof.key_averages():
        for n in names:
            if (ev.device_type == DeviceType.CUDA if n is None
                    else n in ev.key):
                out[n][0] += (getattr(ev, "device_time_total", 0.0)
                              or getattr(ev, "cuda_time_total", 0.0))
                out[n][1] += ev.count
    return out


def device_ms(fn, name, reps=50, tries=3):
    """Device time per call of ``fn`` of the kernels whose name holds
    ``name`` (every kernel ``fn`` launches where ``name`` is None), from
    ``torch.profiler``'s ``key_averages()`` over ``reps`` calls (one
    warm-up first); a fresh profiler up to ``tries`` times, since CUPTI
    now and then delivers no record of a run; None if none recorded it."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        total = _profiled(fn, (name,), reps)[name][0]
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


def flushed_ms(fn, reps=20):
    """Device ms per call of ``fn`` with the 50 MB L2 cache flushed before
    each call (a 256 MB buffer written), from a CUDA event pair around
    each call, all queued behind a ``torch.cuda._sleep`` as in
    :func:`queued_ms`, so the events time device work on cold inputs."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        flush.zero_()
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)  # >= 2x at <= 2 GHz
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    ev[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


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


def _synthetic_run(tmp, phase, epochs=2, **kw):
    """One ``trainer.train`` run (``epochs`` epochs of batch 100, 'prng'
    masks) on the dataset under ``tmp``, with every count set to 0 just
    before and read just after; checks the metric CSV and returns the
    counts."""
    import numpy as np
    import torch

    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import trainer
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    models = os.path.join(tmp, "models_" + phase)
    fs.reset_launch_counts()
    trainer.train(epochs=epochs, batch_size=100, dropout_rate=0.1,
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
    if len(rows) != epochs:
        raise AssertionError(f"expected {epochs} metric rows, got "
                             f"{len(rows)}")
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


def _check_stage_counts(phase, n_bwd):
    """K2's stage launches of the run just made (``STAGE_LAUNCHES``, set
    to 0 with the counts) for its ``n_bwd`` resident K2 calls: each stage
    the same positive multiple of them (a launch a chunk); returns them."""
    from njode_tpu_torch.ops import fused_scan as fs

    got = dict(fs.STAGE_LAUNCHES)
    n = got["njode_bwd_chain"]
    if n <= 0 or n % n_bwd or set(got.values()) != {n}:
        raise AssertionError(f"{phase}: K2's stage launches {got} for "
                             f"{n_bwd} calls")
    say(phase, k2_stage_launches=json.dumps(got).replace(" ", ""),
        chunks_a_call=n // n_bwd)
    return got


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
        results["stage_launches"] = _check_stage_counts("trainer", steps)
        # the same run in one chunk of 2 epochs (train_epochs)
        t0 = time.time()
        chunk = _synthetic_run(tmp, "chunk", epoch_chunk=2)
        _check_counts("chunk", chunk, expect)
        results["chunk_stage_launches"] = _check_stage_counts("chunk", steps)
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


def gob_setup(B, K, hidden, impute, mixing, seed, device, p_hidden=None,
              prep=None):
    """A GRU-ODE-Bayes model at the published widths (every width
    ``hidden``, p_hidden and prep_hidden where given) and a BlackScholes
    batch (obs_perc 0.1) on the card; returns (cfg, model, batch, arrays,
    leaves, (h0, m0, v0))."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid, sde
    from njode_tpu_torch.data.datasets import hyperparam_default
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    cfg = gob.GOBConfig(input_size=1, hidden_size=hidden,
                        p_hidden=p_hidden or hidden,
                        prep_hidden=prep or hidden, cov_size=1,
                        cov_hidden=hidden,
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


def _k2_written(spec):
    """The workspace fields K2 writes in the spec's plan: stage (a)'s
    forward fields (resident) or the global chain's Linear inputs, then
    the chain's deltas; the mask words apart (checked through the
    deltas)."""
    kinds = "xfd" if spec.plan == "resident" else "xd"
    return [(n, k) for n, _, k in spec.ws_fields if k in kinds
            and n != ("mw",) and not (n[0] == "le" and spec.D != spec.O)]


def k2_stage_checks(tag, spec, leaves, arrays, hists, u, seed,
                    members=False):
    """K2's three stages on the card against their plain versions
    (``fused_scan.scan_bwd_staged_plain``, or its member form): the call
    twice bit for bit (gradients, dh0 and every field it writes); the
    workspace of its first chunk field by field, stage (a)'s forward
    fields (the global plan: the chain's Linear inputs) and the chain's
    deltas within GRAD_TOL scaled by the reference's largest |value|
    (``scaled_tol``); dh0 and stage (c)'s gradients at GRAD_TOL. A
    member launch's chunk may be shorter than its members' solo chunks:
    the fields are compared over the rows both cover. Returns the largest
    absolute errors {"remat", "chain", "wgrad"}; prints the workspace's
    bytes."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = hists[0].device
    if members:
        E, K, B = arrays[2].shape
        dloss = torch.linspace(0.8, 1.2, E, device=dev)
        cuda, plain = fs.scan_bwd_members_cuda, fs.scan_bwd_members_staged_plain
    else:
        E, (K, B) = 1, arrays[2].shape
        dloss = torch.ones((), device=dev)
        cuda, plain = fs.scan_bwd_cuda, fs.scan_bwd_staged_plain
    written = _k2_written(spec)

    def fields(ws, n):
        return [fs.ws_view(spec, ws[..., :n, :], f) for f, _ in written]

    runs = [cuda(spec, leaves, arrays, 0.5, True, hists, dloss, u, seed,
                 want_ws=True) for _ in range(2)]
    torch.cuda.synchronize()
    (g1, d1, w1), (g2, d2, w2) = runs
    n = w1.shape[-2]
    if not all(torch.equal(a, b) for a, b in zip(
            g1 + [d1] + fields(w1, n), g2 + [d2] + fields(w2, n))):
        raise AssertionError(f"K2 stages ({tag}) differ between two runs")
    gp, dp, wp = plain(spec, leaves, arrays, 0.5, True, hists, dloss, u,
                       seed, want_ws=True)
    n = min(n, wp.shape[-2])
    err = {"remat": 0.0, "chain": 0.0, "wgrad": 0.0}
    for (f, kind), a, b in zip(written, fields(w1, n), fields(wp, n)):
        key = "chain" if kind == "d" else "remat"
        err[key] = max(err[key], check_close(
            f"K2 stage {'(b) delta' if kind == 'd' else '(a) field'} {f} "
            f"({tag})", a, b, scaled_tol(b)))
    err["chain"] = max(err["chain"], check_close(
        f"K2 stages dh0 ({tag})", d1, dp, GRAD_TOL))
    for i, (a, b) in enumerate(zip(g1, gp)):
        err["wgrad"] = max(err["wgrad"], check_close(
            f"K2 stage (c) grad {i} ({tag})", a, b, GRAD_TOL))
    Kc = spec.bwd_chunk(K, B, E)
    say("k2_stages", arm=tag, plan=spec.plan, rows=spec.rows_for(B),
        remat_rows=spec.remat_rows() if spec.plan == "resident" else 0,
        E=E, K=K, B=B, chunk=Kc, stretch=spec.wgrad_steps(B),
        chunks=-(-K // Kc), rec_floats=spec.rec,
        ws_bytes=4 * E * Kc * B * spec.rec,
        **{f"{k}_err": f"{v:.3e}" for k, v in err.items()},
        bitwise_repeat=True)
    return err


def _k2_staged_plain_ms(spec, leaves, arrays, hists, seed):
    """CUDA-event ms of the plain version of each of K2's stages ('prng'
    masks): ``fused_scan.scan_bwd_staged_plain`` run once, each chunk's
    stages timed through its ``timer`` and summed over the chunks."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    ms = {"remat": 0.0, "chain": 0.0, "wgrad": 0.0}

    def timer(stage, fn):
        out, t = timed(fn)
        ms[stage] += t
        return out

    fs.scan_bwd_staged_plain(spec, leaves, arrays, 0.5, True, hists,
                             torch.ones((), device=hists[0].device), None,
                             seed, timer=timer)
    return ms


def _wgrad_library(spec, view, out_major):
    """Stage (c)'s jobs (``spec.wgrad_jobs()``) as PyTorch calls on the
    kernel's own workspace, ``view(field)`` a field's [records, width]:
    torch.matmul of each d^T x (``out_major``, NJODE's [out, in] leaves)
    or x^T d (GRU-ODE-Bayes' [in, out]), sum for a bias. The yardstick of
    njode_wgrad_kernel and gob_wgrad_kernel, used nowhere in the port."""
    import torch

    out = []
    for _, x, d in spec.wgrad_jobs():
        dm = view(d)
        out.append(dm.sum(0) if x is None
                   else torch.matmul(dm.t(), view(x)) if out_major
                   else torch.matmul(view(x).t(), dm))
    return out


def k2_stage_bounds(spec, K, B):
    """The least time of each of K2's stages at K steps of B rows:
    max(FLOP / 67 TFLOP/s, bytes / 3.35 TB/s). (a): the forward's products
    (2 MACs' FLOP a MAC), its inputs and stored carries read and its
    forward fields written; (b) the chain: the dx products (about the
    forward's) and those fields read, its deltas written; (c): d^T x of
    every job over every (step, row), the Linear inputs and the deltas
    read, the stretch partials written."""
    w = dict((n, w) for n, w, _ in spec.ws_fields)
    n_f = sum(w[n] for n, _, k in spec.ws_fields if k in "xf")
    n_x = sum(w[n] for n, _, k in spec.ws_fields if k == "x")
    n_d = sum(w[n] for n, _, k in spec.ws_fields if k == "d")
    KB = K * B
    f_fwd = 2.0 * _macs_per_row_step(spec) * KB
    inputs = 4 * KB * (spec.H + 2 * spec.D + 2) + 4 * spec.n_params
    ins = dict((n, w) for n, w, _ in spec.ws_fields)
    f_c = 2.0 * KB * sum(
        spec.leaf_shapes[leaf][0] * (ins[x] if x else 1)
        for leaf, x, _ in spec.wgrad_jobs())
    parts = 4 * -(-K // spec.wgrad_steps(B)) * spec.n_params
    return {"remat": bound(f_fwd, inputs + 4 * KB * n_f, PEAK_FP32),
            "chain": bound(f_fwd, 4 * KB * (n_f + n_d), PEAK_FP32),
            "wgrad": bound(f_c, 4 * KB * (n_x + n_d) + parts, PEAK_FP32)}


def phase_k2_stages(results):
    """K2's three stages (stage (a) the forward re-run, stage (b) the
    chain, stage (c) the weight gradients; one C call, ``k2_stage_checks``)
    against their plain versions at the main path (B = 100 and 200), the
    GRU jump, the climate small arm and the PhysioNet 50 arm (their first
    100 steps), an output of another width than the input (E3a, the
    global plan), ODE nets of 9 and 16 linears, and over a member axis (E
    = 3, main path; each member bit for bit its solo call); then each
    stage's device time at the main path (``stage_device_ms``; they must
    sum to the call's CUDA-event time), its plain version's, its bound,
    and stage (c)'s PyTorch yardstick."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    err = {"remat": 0.0, "chain": 0.0, "wgrad": 0.0}

    def check(tag, cfg, model, batch, members=None):
        spec = fs.Spec(cfg, "prng")
        if members is None:
            leaves = [p.detach() for p in fs.flat_leaves(model)]
            arrays = fs.batch_arrays(batch)
            K, B = arrays[2].shape
            with torch.no_grad():
                h0 = fs.t0_state(model, batch)
            seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev,
                                 dtype=torch.int64)
            _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True,
                                        None, seed)
        else:
            solo, leaves, arrays, h0 = _member_layout(*members)
            E, K, B = arrays[2].shape
            _, seed = _member_draws(spec, E, K, B, "prng", gen, dev)
            _, hists = fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.5,
                                                h0, True, None, seed)
        e = k2_stage_checks(tag, spec, leaves, arrays, hists, None, seed,
                            members is not None)
        for k, v in e.items():
            err[k] = max(err[k], v)
        if members is not None:
            # each member its solo call's bits (a solo call's chunk may
            # be longer than the member launch's)
            dl = torch.linspace(0.8, 1.2, E, device=dev)
            g_e, d_e = fs.scan_bwd_members_cuda(spec, leaves, arrays, 0.5,
                                                True, hists, dl, None, seed)
            for i, (lv, arr, _) in enumerate(solo):
                g, d = fs.scan_bwd_cuda(spec, lv, arr, 0.5, True,
                                        tuple(h[i] for h in hists), dl[i],
                                        None, seed[i:i + 1])
                if not all(torch.equal(a[i], b)
                           for a, b in zip(g_e + [d_e], g + [d])):
                    raise AssertionError(f"K2 stages ({tag}): member {i} "
                                         "differs from its solo call")
            say("k2_stages", arm=tag, members_equal_solo_bitwise=True)
        return spec, leaves, arrays, hists, seed

    for B in (100, 200):
        cfg, model, batch = main_path_setup(B, 100, 5, dev)
        main = check(f"main_B{B}", cfg, model, batch)
    cfg, model, batch = main_path_setup(200, 100, 6, dev, use_rnn=True)
    check("rnn_B200", cfg, model, batch)
    cfg, model = _masked_njode(5, 10, 50, dev)
    check("climate_small", cfg, model,
          _first_steps(results["climate"]["batch"], 100))
    cfg, model = _masked_njode(41, 41, 50, dev)
    check("phys50", cfg, model, _first_steps(results["phys"]["batch"], 100))
    cfg, model, batch = main_path_setup(100, 100, 7, dev,
                                        data=("HestonWOFeller", HWOF_RV),
                                        output_size=1)
    check("e3a_D2_O1", cfg, model, batch)
    for n_lin in (9, 16):
        cfg, model, batch = main_path_setup(
            100, 100, 8, dev, ode_nn=((50, "tanh"),) * (n_lin - 1))
        check(f"deep{n_lin}", cfg, model, batch)
    sets = [main_path_setup(100, 100, 30 + e, dev) for e in range(3)]
    check("members_E3", sets[0][0], None, None,
          members=([m for _, m, _ in sets], [b for _, _, b in sets]))
    # the stages' device times at the main path (B = 200, the K2 row's)
    spec, leaves, arrays, hists, seed = main
    K, B = arrays[2].shape
    dl = torch.ones((), device=dev)
    bwd = lambda: fs.scan_bwd_cuda(spec, leaves, arrays, 0.5,  # noqa
                                   True, hists, dl, None, seed)
    chunks = -(-K // spec.bwd_chunk(K, B))
    whole = cuda_ms(bwd, 20)
    ms = stage_device_ms(bwd, 5, chunks, whole, kernels=K2_STAGES)
    plain = _k2_staged_plain_ms(spec, leaves, arrays, hists, seed)
    bd = k2_stage_bounds(spec, K, B)
    # stage (c)'s yardstick on the records the call's stage (c) sums: the
    # workspace of all K steps (one chunk of K; a chunk's alone holds
    # Kc / K of them)
    _, _, ws = fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, True, hists, dl,
                                None, seed, chunk=K, want_ws=True)
    ws = ws[:K * B]
    lib_ms = device_ms(lambda: _wgrad_library(
        spec, lambda f: fs.ws_view(spec, ws, f), True), None, reps=10)
    for k in ("remat", "chain", "wgrad"):
        say("k2_stages", stage=k, B=B, K=K, chunks=chunks,
            ms=f"{ms[k]:.5f}", plain_ms=f"{plain[k]:.3f}",
            bound_ms=f"{bd[k][0]:.6f}", bound_by=bd[k][1],
            **({"library_ms": f"{lib_ms:.5f}"} if k == "wgrad" else {}))
    say("k2_stages", K2_ms=f"{whole:.4f}", stages_sum_ms=f"{sum(ms.values()):.4f}",
        errs=json.dumps({k: f"{v:.3e}" for k, v in err.items()})
        .replace(" ", ""))
    results["k2_stages"] = dict(ms=ms, plain=plain, bounds=bd, errs=err,
                                library_ms=lib_ms, chunks=chunks)


# K2's stages (fused_scan.cu): stage (a), the chain, stage (c); the global
# plan's K2 has no stage (a) (its chain re-runs each step itself)
K2_STAGES = {"remat": "njode_remat_kernel", "chain": "njode_scan_bwd_kernel",
             "wgrad": "njode_wgrad_kernel"}


def stage_device_ms(fn, reps, chunks, whole_ms=None, tries=3, kernels=None):
    """Device ms per K6 call (or K2's, ``kernels``: {stage: kernel name})
    of each stage's kernel (a stage launches once a chunk, ``chunks`` a
    call) from a torch.profiler run of ``reps`` calls, opened with warm-up
    launches: CUPTI now and then loses records, and a sum over fewer reads
    too fast (16x in one run). Up to ``tries`` runs for one with every
    record; else, from the run with the most, each stage's mean over the
    records it has, times ``chunks``, where every stage kept at least 90 %
    of them (said on a line). Given ``whole_ms`` (the call's CUDA-event
    ms), the stages must sum to 0.8-1.05 of it. The run fails otherwise,
    as one C call launches them all and no event can part them."""
    import torch

    names = kernels or {n: f"gob_{n}_kernel"
                        for n in ("remat", "chain", "wgrad")}
    want = chunks * reps
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        got = _profiled(fn, tuple(names.values()), reps, warm=True)
        have = min(got[k][1] for k in names.values())
        if best is None or have > best[0]:
            best = (have, got)
        if have == want and all(got[k][1] == want for k in names.values()):
            break
    have, got = best
    if have < 0.9 * want or any(got[k][1] > want for k in names.values()):
        raise AssertionError(f"torch.profiler recorded the stages in part "
                             f"(records, want {want} each): {got}")
    out = {n: got[k][0] / 1e3 / got[k][1] * chunks
           for n, k in names.items()}
    if have < want:
        say("profiler", kernel=" ".join(names.values()), records=json.dumps(
            {n: got[k][1] for n, k in names.items()}), want=want,
            timed_by="mean_of_the_records_x_chunks")
    if whole_ms is not None and not (
            0.8 * whole_ms <= sum(out.values()) <= 1.05 * whole_ms):
        raise AssertionError(
            f"the stages {out} do not sum to the call's {whole_ms:.4f} ms")
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
        stages = stage_device_ms(bwd, 5, -(-K // spec.bwd_chunk(K, B)))
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
            lib = kernel_ms(lambda: _wgrad_library(
                spec, lambda f: fg.ws_view(spec, ws, K * B, f), False), None,
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


def _gob_run(tmp, phase, epochs=2, train_size=GOB_TRAIN_SIZE, hidden=50,
             gob_opts=None, **kw):
    """One GOB ``trainer.train`` run (``epochs`` epochs of ``train_size``
    paths, every width ``hidden``, the 'GRU_ODE_Bayes-' options
    ``gob_opts`` over impute, logvar and mixing 1e-4) on the dataset under
    ``tmp``, with every count set to 0 just before and read just after;
    checks the metric CSV and the launch counts (exactly what the epochs
    need) and returns the counts."""
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
    opts = {"GRU_ODE_Bayes-impute": True, "GRU_ODE_Bayes-logvar": True,
            "GRU_ODE_Bayes-mixing": 1e-4, **(gob_opts or {})}
    with chunks:
        trainer.train(epochs=epochs, batch_size=20, hidden_size=hidden,
                      dropout_rate=0.1, dataset="BlackScholes",
                      plot=False, evaluate=True,
                      other_model="GRU_ODE_Bayes",
                      training_size=train_size,
                      base_data_path=os.path.join(tmp, "data"),
                      saved_models_path=models, **opts, **kw)
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
    if len(rows) != epochs:
        raise AssertionError(f"expected {epochs} metric rows, got "
                             f"{len(rows)}")
    steps = epochs * (train_size // 20)
    expect = chunks.expect(steps, evals=epochs, reduce_extra=epochs)
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
    results["bench_stage_launches"] = _check_stage_counts("bench", steps)
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


def _gob_checks(spec, leaves, arrays, st, u, seed, tag, arm="climate"):
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
        raise AssertionError(f"K5 {arm} ({tag}) differs between two runs")
    ms = {}
    (lp, hp), ms["K5c"] = timed(lambda: fg.gob_scan_fwd_plain(
        spec, leaves, arrays, *st, True, u, seed))
    e = {"loss": check_close(f"K5 {arm} loss ({tag})", lk, lp, LOSS_TOL),
         "loss_val": float(lp)}
    e["hist"] = max(check_close(f"K5 {arm} {n} ({tag})", a, c,
                                scaled_tol(c))
                    for n, a, c in zip("hmv", hk, hp))
    dloss = torch.ones((), device=lk.device)
    outs = [fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                                 seed) for _ in range(2)]
    torch.cuda.synchronize()
    (gk, *dk), (gk2, *dk2) = outs
    if not all(torch.equal(a, c) for a, c in
               zip(list(gk) + dk, list(gk2) + dk2)):
        raise AssertionError(f"K6 {arm} ({tag}) differs between two runs")
    (gp, *dp), ms["K6c"] = timed(lambda: fg.gob_scan_bwd_plain(
        spec, leaves, arrays, True, hk, dloss, u, seed))
    e.update(_grad_errs(f"K6 {arm} ({tag})", gk, gp))
    e["d0"] = max(check_close(f"K6 {arm} {n} ({tag})", a, c, scaled_tol(c))
                  for n, a, c in zip(("dh0", "dm0", "dv0"), dk, dp))
    return e, ms, hk


def phase_climate_kernels(results):
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    dev = torch.device("cuda")
    full = results["climate"]["batch"]
    cfg, model = _masked_njode(5, 10, 50, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, plain_ms, _ = _masked_arm_checks(
        "climate_kernels", cfg, model, full,
        ((100, ("input", "prng"), SHORT_TOL),
         (CLIMATE_CHECK_K, ("prng",), LONG_TOL)), gen)
    results["climate"].update(njode=(cfg, model), plain_ms=plain_ms)
    check_waves("climate_kernels", "climate_small", cfg, CLIMATE_B)

    # K5/K6 at the GRU-ODE-Bayes climate arm: the first 100 steps in both
    # mask modes, the first CLIMATE_CHECK_K of the trainer's 2,004 in
    # 'prng' mode
    gcfg, gmodel = _climate_gob(dev)
    gleaves = [p.detach() for p in fg.flat_leaves(gmodel, fg.Spec(gcfg))]
    gerr = {"K5c": 0.0, "K6c": 0.0}
    for K, modes in ((100, ("input", "prng")),
                     (CLIMATE_CHECK_K, ("prng",))):
        garrays, st = _climate_gob_inputs(gmodel, full, K)
        for mode in modes:
            spec = fg.Spec(gcfg, mode)
            u = seed = None
            if mode == "input":
                u = (torch.rand((K, 3, CLIMATE_B, spec.P), generator=gen,
                                device=dev) < 0.8).to(torch.int8)
            else:
                seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                     device=dev, dtype=torch.int64)
            e, gplain_ms, _ = _gob_checks(spec, gleaves, garrays, st, u,
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
    results["climate"]["gob"] = (gcfg, gmodel, gleaves)
    results["climate_errs"] = dict(errs, **gerr)


def _climate_gob_inputs(gmodel, full, K):
    """The GOB climate arm's batch arrays over the first K steps of
    ``full`` and its t=0 state (h0, m0, v0)."""
    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob

    b = _first_steps(full, K)
    with torch.no_grad():
        h0 = gob.mlp2(gmodel.covariates_map, b.start_X, 0.0)
        p0 = gob.mlp2(gmodel.p_model, h0, 0.0)
    return ((b.times, b.dt, b.obs, b.X, b.M),
            (h0.contiguous(), p0[:, :5].contiguous(), p0[:, 5:].contiguous()))


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
    written once (K2's: the gradients and dh0)."""
    mac = _macs_per_row_step(spec)
    D, H, P = spec.D, spec.H, spec.n_params
    n_fwd = -(-B // spec.rows_for(B, False))
    nX = 2 if spec.masked else 1
    data = 4 * (2 * K + K * B + nX * K * B * D + B + B * D + B * H + P)
    hist = 4 * K * B * (H + D + 1)
    f1 = 2.0 * mac * B * K
    return {"K1": bound(f1, data + 8 + hist + 4 * n_fwd, PEAK_FP32),
            "K2": bound(3.0 * f1, data + 8 + hist + 4 + 4 * P + 4 * B * H,
                        PEAK_FP32),
            "K3": bound(f1, data + 4 * n_fwd, PEAK_FP32)}


def phase_climate_timing(results):
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs

    cl = results["climate"]
    cfg, model = cl["njode"]
    full = cl["batch"]
    gcfg, gmodel, gleaves = cl["gob"]
    gspec = fg.Spec(gcfg, "prng")
    t, bnd = {}, {}
    # each kernel over all 2,004 steps (the trainer's shape), then over the
    # steps climate_kernels checked, beside the plain versions' time there
    # (the kernels line's pair)
    for K in (cl["K"], CLIMATE_CHECK_K):
        b = _first_steps(full, K)
        B = int(b.obs.shape[1])
        leaves = [p.detach() for p in fs.flat_leaves(model)]
        arrays = fs.batch_arrays(b)
        with torch.no_grad():
            h0 = fs.t0_state(model, b)
        seed = torch.tensor([20261017], dtype=torch.int64, device=h0.device)
        spec = fs.Spec(cfg, "prng")
        _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True,
                                    None, seed)
        ms = _masked_times(spec, fs.Spec(cfg, "input"), leaves, arrays, h0,
                           seed, hists, 3)
        t.update({k + "m": (ms[k], cl["plain_ms"][k + "m"]) for k in ms})
        bnd.update({k + "m": v for k, v in _scan_bounds(spec, K, B).items()})
        garrays, st = _climate_gob_inputs(gmodel, full, K)
        _, ghists = fg.gob_scan_fwd_cuda(gspec, gleaves, garrays, *st, True,
                                         None, seed)
        dloss = torch.ones((), device=h0.device)
        t["K5c"] = (cuda_ms(lambda: fg.gob_scan_fwd_cuda(
            gspec, gleaves, garrays, *st, True, None, seed), 2, 1),
            cl["plain_ms"]["K5c"])
        gbwd = lambda: fg.gob_scan_bwd_cuda(  # noqa: E731
            gspec, gleaves, garrays, True, ghists, dloss, None, seed)
        t["K6c"] = (cuda_ms(gbwd, 2, 1), cl["plain_ms"]["K6c"])
        (f5, b5), (f6, b6) = gob_bounds(gspec, K, B)
        bnd["K5c"] = bound(f5, b5, PEAK_FP32)
        bnd["K6c"] = bound(f6, b6, PEAK_FP32)
        if K == cl["K"]:
            mask_cost_njode("climate_timing", "climate_small", cfg, leaves,
                            arrays, h0, 2)
            stages = stage_device_ms(gbwd, 2,
                                     -(-K // gspec.bwd_chunk(K, B)))
            say("climate_timing", kernel="K6c_stages", R=gspec.rows_for(B),
                chunks=-(-K // gspec.bwd_chunk(K, B)),
                **{f"{n}_device_ms": f"{v:.4f}" for n, v in stages.items()})
            mask_cost_gob("climate_timing", "climate_gob", gcfg, gleaves,
                          garrays, st, 2)
        for k in ("K1m", "K2m", "K3m", "K5c", "K6c"):
            ms, plain = t[k]
            bms, by = bnd[k]
            # the plain versions ran over CLIMATE_CHECK_K steps
            say("climate_timing", kernel=k, B=B, K=K, ms=f"{ms:.4f}",
                ms_per_step=f"{ms / K:.5f}", bound_ms=f"{bms:.6f}",
                bound_by=by, roofline_share=f"{bms / ms:.2e}",
                **({"plain_ms": f"{plain:.4f}"}
                   if K == CLIMATE_CHECK_K else {}))
    results["times"].update(t)
    results["bounds"].update(bnd)


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
    steps = -(-results["climate"]["n_train"] // CLIMATE_B)
    # one epoch of each arm; eval runs the eager forward
    nj = _climate_run(results, "njode", {
        "njode_scan_fwd": steps, "njode_scan_bwd": steps,
        "philox_keep": 2 * steps, "reduce_partials": 2 * steps},
        epochs=1, rows_cfg=_masked_cfg(5, 10, 50), hidden_size=10,
        dropout_rate=0.1)
    gb = _climate_run(results, "gob", lambda chunks: chunks.expect(steps),
        epochs=1, hidden_size=50, dropout_rate=0.2, ode_nn=None,
        readout_nn=None, enc_nn=None, other_model="GRU_ODE_Bayes",
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
                         phase="physionet_kernels", at16=True):
    """The global plan against the resident plan at the same rows, every
    output of K1, K2 and K3 in both mask modes, bit for bit: both forced at
    16 rows (``at16``; not where the resident plan does not fit 16), and
    the global plan forced at the rows the rule takes at this batch (one a
    CTA) against the rule's own launches."""
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
        for pair in (((("resident", 16), ("global", 16)),) * at16
                     + ((None, ("global", R)),)):
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
        if arm == "phys50":          # the trainer's shape, step by step
            runs += ((PHYS_STEPWISE_K, ("prng",), STEP_TOL),)
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
                # the kernels line's pair: kernel and plain version over the
                # steps the step-by-step check ran
                ms, bd, K, B, spec = _full_grid_times(
                    a["cfg"], a["model"], _first_steps(a["full"],
                                                       PHYS_STEPWISE_K),
                    3, plan)
                _say_times("physionet_timing", arm, spec, ms, bd, K, B)
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
    steps = -(-int(0.8 * PHYS_TRAIN_RECORDS) // PHYS_B)
    # one epoch of the 50 arm: the resident plan, one row a CTA (the rule)
    results["phys_launches"] = _physionet_run(
        results, "physionet_trainer", 1,
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


def _check_plan(phase, arm, spec, plan, rows=16):
    """Fail unless ``spec`` takes ``plan`` at ``rows`` rows; print its
    sizes."""
    if (spec.plan, spec.rows) != (plan, rows):
        raise AssertionError(f"{arm}: plan {spec.plan} at {spec.rows} rows, "
                             f"expected {plan} at {rows}")
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
    """The masked GRU jump at the PhysioNet 50 arm in the resident plan
    (the most rows that fit 4, one a CTA at B = 50): K1-K3 against their
    plain versions over the first 100 steps of the first batch in both
    modes, and CUDA-event times and bounds over all 3,006 steps; then the
    same in the global plan forced at 16 rows (the only masked GRU-jump
    check of that plan), with K2's stages against their plain versions."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    full = results["phys"]["batch"]
    cfg, model = _masked_njode(41, 41, 50, dev, use_rnn=True)
    _check_plan("physionet_rnn", "phys50", fs.Spec(cfg), "resident", 4)
    gen = torch.Generator(device=dev).manual_seed(8)
    errs, _, _ = _masked_arm_checks(
        "physionet_rnn", cfg, model, full,
        ((100, ("input", "prng"), SHORT_TOL),),
        gen, arm="phys50")
    ms, bd, K, B, spec = _full_grid_times(cfg, model, full, 2)
    _say_times("physionet_rnn", "phys50", spec, ms, bd, K, B)
    forced = ("global", 16)
    errs_g, _, (leaves, arrays, _, seed, hists) = _masked_arm_checks(
        "physionet_rnn", cfg, model, full,
        ((100, ("input", "prng"), SHORT_TOL),),
        torch.Generator(device=dev).manual_seed(9), forced,
        arm="phys50_global16")
    k2_stage_checks("phys50_rnn_global16", fs.Spec(cfg, "prng", forced),
                    leaves, arrays, hists, None, seed)
    with torch.no_grad():
        h0 = fs.t0_state(model, _first_steps(full, 100))
    _plans_bit_identical("phys50_rnn", cfg, leaves, arrays, h0,
                         torch.Generator(device=dev).manual_seed(10),
                         "physionet_rnn", at16=False)
    errs = {k: max(v, errs_g[k]) for k, v in errs.items()}
    ms_g, bd_g, K, B, spec_g = _full_grid_times(cfg, model, full, 2, forced)
    _say_times("physionet_rnn", "phys50_global16", spec_g, ms_g, bd_g, K, B)
    # one epoch of the trainer with the GRU jump: the resident plan's path
    n_b = -(-int(0.8 * PHYS_TRAIN_RECORDS) // PHYS_B)
    counts = _physionet_run(
        results, "physionet_rnn", 1,
        {"njode_scan_fwd_rnn": n_b, "njode_scan_bwd_rnn": n_b,
         "philox_keep": 2 * n_b, "reduce_partials": 2 * n_b},
        rows_cfg=cfg, use_rnn=True)
    results["phys_rnn"] = dict(errs=errs, ms=ms, bd=bd, launches=counts)


# the sweep phase's depth cut: one epoch of each run, on the convergence
# study's own smallest training size and on SWEEP_TRAIN paths elsewhere
SWEEP_TRAIN = {20: 1000, 100: 2000}     # batch size -> training paths
# widths whose nets take the global plan (checked against fused_scan.Spec)
SWEEP_GLOBAL_WIDTHS = (160, 320, 400)
# heston_wo_feller's 2-D return_vol dataset (experiments/configs.py)
HWOF_RV = {"drift": 2.0, "volatility": 3.0, "mean": 1.0, "speed": 2.0,
           "correlation": 0.5, "S0": 1, "maturity": 1.0, "dimension": 2,
           "scheme": "euler", "return_vol": True, "v0": 0.5}
# K1/K2 (with K3) against their plain versions at every shape the sweep's
# unmasked runs take: (arm, width, B, the plan and rows the rule must take,
# K2's and, where they differ, K1/K3's, (SDE model, hyperparameters) of the
# batch, timed). Timed: the global-plan shapes and the 2-D one. The
# resident arms at B = 20 (the convergence study's widths 10-80, the
# GRU-ODE-Bayes comparison's NJODE at 50) are only checked.
BS = ("BlackScholes", {})
SWEEP_SHAPES = (("sine400", 400, 100, ("global", 4, 1), BS, True),
                ("conv320", 320, 20, ("global", 8, 1), BS, True),
                ("conv160", 160, 20, ("global", 16, 2), BS, True),
                ("combined100", 100, 100, ("resident", 1), BS, True),
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


def _global_rows_check(arm, cfg, model, batch, rows):
    """K1 ('prng') and K3 of the global plan at the rows its forward rule
    takes against the plan forced at ``rows`` (K2's): the histories bit
    for bit (a row's sums run in one order at any rows), the losses (the
    per-CTA sums taken over other CTAs) at LOSS_TOL."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    leaves = [p.detach() for p in fs.flat_leaves(model)]
    arrays = fs.batch_arrays(batch)
    with torch.no_grad():
        h0 = fs.t0_state(model, batch)
    seed = torch.tensor([20261019], dtype=torch.int64, device=h0.device)
    out = []
    for plan in (None, ("global", rows)):
        sp, s3 = fs.Spec(cfg, "prng", plan), fs.Spec(cfg, "input", plan)
        lk, hk = fs.scan_fwd_cuda(sp, leaves, arrays, 0.5, h0, True, None,
                                  seed)
        l3, _ = fs.scan_fwd_cuda(s3, leaves, arrays, 0.5, h0, False,
                                 want_hists=False)
        out.append((lk, hk, l3))
    (la, ha, a3), (lb, hb, b3) = out
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(ha, hb)):
        raise AssertionError(f"sweep {arm}: K1's histories at the rule's "
                             f"rows differ from those at {rows}")
    e1 = check_close(f"sweep {arm} K1 loss", la, lb, LOSS_TOL)
    e3 = check_close(f"sweep {arm} K3 loss", a3, b3, LOSS_TOL)
    say("sweep", arm=arm, fwd_rows=fs.Spec(cfg).rows_for(
        arrays[2].shape[1], False), against_rows=rows, hists_bit_equal=True,
        K1_loss_err=f"{e1:.3e}", K3_loss_err=f"{e3:.3e}")


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
                plan[0], plan[1], plan[-1]):
            raise AssertionError(f"sweep {arm}: plan {spec.plan} at "
                                 f"{spec.rows_for(B)} / "
                                 f"{spec.rows_for(B, False)} rows, expected "
                                 f"{plan}")
        if plan[-1] != plan[1]:
            _global_rows_check(arm, cfg, model, batch, plan[1])
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
GROUP_K_PLAIN = 25         # the steps each member check holds to the plain
GROUP_CONV_REPEATS, GROUP_CLIMATE_FOLDS, GROUP_PHYS_REPEATS = 5, 2, 2


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
        k1c = fs.make_cfg(spec, K, B, True, 0.5, bwd=False, E=E)
        walk = k1_probe_check(f"groups {arm}", spec, k1c)
        if arm == "main" and walk["threads"] != 128:
            raise AssertionError(f"groups main: K1's member launch ran "
                                 f"{walk['threads']} threads a CTA, not "
                                 "128")
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
            K1_threads=walk["threads"], K1_walk=walk["walk"],
            K1_phases=walk["phases_per_step"],
            bit_equal_to_solo=True, bitwise_repeat=True,
            K1_loss_err=f"{e1:.3e}", K1_hist_err=f"{eh:.3e}",
            K2_grad_err=f"{e2:.3e}", K2_dh0_err=f"{ed:.3e}",
            plain_fwd_ms=f"{plain_fwd:.1f}", plain_bwd_ms=f"{plain_bwd:.1f}")
    return errs


def k1_probe_check(phase, spec, c):
    """K1's probe of its last launch (``fs.k1_probe``: what CTA 0 wrote of
    itself, its walk, threads a CTA and, in the role walk, the phases its
    middle step ended), held against the launch's config ``c`` and the
    spec's walk (``Spec.k1_phases``); returns the probe."""
    from njode_tpu_torch.ops import fused_scan as fs

    got = fs.k1_probe()
    walk = spec.k1_phases(c.rows) or ("global", None)
    want = {"walk": walk[0], "threads": c.threads,
            "phases_per_step": walk[1] if walk[0] == "roles" else None}
    if got != want:
        raise AssertionError(f"{phase}: K1's probe {got}, its config "
                             f"{want}")
    return got


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

    k1c = fs.make_cfg(spec, K, B, True, 0.5, bwd=False, E=E)
    t = {"K1": cuda_ms(lambda: fs.scan_fwd_members_cuda(
            spec, leaves, arrays, 0.5, h0, True, None, seed), reps, 1)}
    walk = k1_probe_check(f"groups {arm}", spec, k1c)
    t |= {"K2": cuda_ms(lambda: fs.scan_bwd_members_cuda(
              spec, leaves, arrays, 0.5, True, hk, ones, None, seed), reps,
              1),
          "K1_solo": cuda_ms(solo_fwd, reps, 1),
          "K2_solo": cuda_ms(solo_bwd, reps, 1)}
    bd = _scan_bounds(spec, K, B)
    out = {"E": E, "B": B, "K": K, "spec": spec}
    for k in ("K1", "K2"):
        bms = E * bd[k][0]
        out[k] = dict(ms=t[k], solo_x_E_ms=t[k + "_solo"], bound_ms=bms,
                      bound_by=bd[k][1])
        if k == "K1":
            out[k].update(walk)
        say("groups", timing=arm, kernel=k + "_members", E=E, B=B, K=K,
            plan=spec.plan, rows=spec.rows_for(B, k == "K2"),
            ctas=E * -(-B // spec.rows_for(B, k == "K2")),
            ms=f"{t[k]:.4f}", ms_per_member=f"{t[k] / E:.4f}",
            solo_x_E_ms=f"{t[k + '_solo']:.4f}",
            solo_ms=f"{t[k + '_solo'] / E:.4f}",
            speedup=f"{t[k + '_solo'] / t[k]:.3f}",
            bound_ms=f"{bms:.6f}", bound_by=bd[k][1],
            roofline_share=f"{bms / t[k]:.2e}",
            **({"K1_threads": walk["threads"], "K1_walk": walk["walk"],
                "K1_phases": walk["phases_per_step"]}
               if k == "K1" else {}))
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
    version and E solo reductions, twice; device ms with the L2 cache
    flushed before each call (``flushed_ms``: the partials, 20 MB at the
    main path's shape, would otherwise stay in the 50 MB L2 between calls
    and beat the bound of their bytes from device memory) beside E solo
    launches' and ``sum(dim=1)``'s, and the warm (``queued_ms``) times;
    the plain version's CUDA-event ms; the bound (its bytes)."""
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
    # device ms from CUDA events around calls queued behind a device sleep:
    # torch.profiler lost records of these calls (a per-call average of
    # 0.38 us, below the 6 us bound)
    warm_ms = queued_ms(lambda: fs.reduce_partials_members_cuda(P))
    dev_ms = flushed_ms(lambda: fs.reduce_partials_members_cuda(P))
    solo_ms = flushed_ms(lambda: [fs.reduce_partials_cuda(P[e])
                                  for e in range(E)])
    lib_ms = flushed_ms(lambda: P.sum(dim=1))
    plain = cuda_ms(lambda: fs.reduce_partials_members_plain(P), 5, 1)
    bms, by = bound(float(E * n_parts * n), 4.0 * E * (n_parts + 1) * n,
                    PEAK_FP32)
    say("groups", timing="reduce_partials_members",
        shape=f"[{E},{n_parts},{n}]", bit_equal=True,
        flushed_ms=f"{dev_ms:.5f}", solo_x_E_flushed_ms=f"{solo_ms:.5f}",
        library_flushed_ms=f"{lib_ms:.5f}", warm_queued_ms=f"{warm_ms:.5f}",
        plain_ms=f"{plain:.4f}",
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
    convergence cell (width 320, 5 repeats), the climate small arm's
    folds 0 and 1, the PhysioNet 50 arm x 2 repeats; one convergence member's row
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
        ("main", _synthetic_members(E, 100, 100, 50),
         dict(K_plain=GROUP_K_PLAIN)),
        ("conv320", _synthetic_members(E, 20, 100, 320),
         dict(K_plain=GROUP_K_PLAIN)),
        ("climate50", _bank_members(E, results["climate"], 5, 10, 50,
                                    CLIMATE_B),
         dict(tol=LONG_TOL, K_plain=GROUP_K_PLAIN)),
        ("phys50", _bank_members(E, results["phys"], 41, 41, 50, PHYS_B),
         dict(tol=LONG_TOL, K_plain=GROUP_K_PLAIN)),
        ("main_rnn", _synthetic_members(E, 100, 100, 50, use_rnn=True),
         dict(K_plain=GROUP_K_PLAIN)))
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


# the parallel phase: the main path's batch (50 rows a rank at 2 ranks),
# the GOB trainer's training paths at 2 ranks (200 steps of 20, 10 rows a
# rank), the convergence group's repeats over 2 ranks (one ghost member)
PAR_B = 100
PAR_EPOCHS = 1             # the main path's epochs in the parallel phase
PAR_GOB_TRAIN = 4000
PAR_CONV_REPEATS = 3
PAR_GOB_OPTS = {"GRU_ODE_Bayes-impute": True, "GRU_ODE_Bayes-logvar": True,
                "GRU_ODE_Bayes-mixing": 1e-4}


def _par_main_kw(tmp, models):
    """The main path's trainer arguments (``PAR_EPOCHS`` epochs of batch
    100, 'prng')."""
    return dict(epochs=PAR_EPOCHS, batch_size=PAR_B, dropout_rate=0.1,
                dataset="BlackScholes", plot=False, evaluate=True,
                pallas_mask_mode="prng",
                base_data_path=os.path.join(tmp, "data"),
                saved_models_path=os.path.join(tmp, models))


def _par_counted(fn):
    """``fn()`` with every count set to 0 just before and read just after
    (and K6's chunks recorded): result, counts, rows a launch, seconds."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs

    fs.reset_launch_counts()
    fg.reset_launch_counts()
    chunks = BwdChunks()
    t0 = time.time()
    with chunks:
        res = fn()
    torch.cuda.synchronize()
    return dict(result=res, secs=time.time() - t0,
                counts=dict(fs.LAUNCHES, **fg.LAUNCHES),
                rows={f"{k}@{B}": (R, n) for (k, B, R), n in
                      sorted(fs.LAUNCH_ROWS.items())},
                chunks=list(chunks.chunks))


def _par_step(kind, mesh):
    """One training step's loss and gradients, 'input' masks from a
    generator seeded 5, reduced over ``mesh`` (None: no mesh): NJODE at the
    main path's width (B = 100, K = 100), GRU-ODE-Bayes at the GOB
    trainer's (hidden 50, B = 20)."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.parallel import sharding

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    if kind == "njode":
        cfg, model, batch = main_path_setup(PAR_B, 100, 3, dev)
        loss = fs.make_fused_loss_fn(cfg, "input", mesh=mesh)(
            model, batch, 0.5, gen, True)
    else:
        cfg, model, batch = gob_setup(20, 100, 50, True, 1e-4, 50, dev)[:3]
        loss = fg.make_fused_loss_fn(cfg, "input", mesh=mesh)(
            model, batch, gen, True)
    loss.backward()
    if mesh is not None:
        loss = sharding.allreduce_grads(
            list(model.parameters()), mesh,
            "mean" if kind == "njode" else "sum", loss)
    return loss.detach().cpu(), [p.grad.detach().cpu()
                                 for p in model.parameters()
                                 if p.grad is not None]


def _same_as_rank0(model, mesh):
    """True where every parameter equals rank 0's bit for bit."""
    import torch

    from njode_tpu_torch.parallel import sharding

    ok = True
    for p in model.parameters():
        ref = p.detach().clone()
        sharding.replicated([ref], mesh)
        ok = ok and torch.equal(ref, p.detach())
    return ok


def parallel_rank(mesh, job):
    """One of the parallel phase's two gloo ranks sharing the card, in a
    process of its own (``parallel.sharding.spawn`` imports this script
    by name; its ``main`` does not run): one NJODE and one GOB step at
    full width, an epoch of the main path, one GOB epoch, one epoch of
    the climate small arm and the convergence group over the mesh, each
    with this rank's launch counts and rows; the trained parameters
    compared with rank 0's."""
    from njode_tpu_torch.parallel import sharding
    from njode_tpu_torch.training import climate_trainer as ct
    from njode_tpu_torch.training import sweeps, trainer

    models = []
    orig = sharding.shard_params

    def shard_params(model, mesh_, optimizer=None):
        # the model each trainer replicates, to compare after its run
        models.append(model)
        return orig(model, mesh_, optimizer)

    sharding.shard_params = shard_params
    tmp = job["tmp"]
    out = {"njode_step": _par_step("njode", mesh),
           "gob_step": _par_step("gob", mesh)}
    out["main"] = _par_counted(lambda: trainer.train(
        mesh=mesh, **_par_main_kw(tmp, "dp_main")))
    out["main"]["same"] = _same_as_rank0(models[-1], mesh)
    out["gob"] = _par_counted(lambda: trainer.train(
        mesh=mesh, epochs=1, batch_size=20, hidden_size=50,
        dropout_rate=0.1, dataset="BlackScholes", plot=False,
        other_model="GRU_ODE_Bayes", training_size=PAR_GOB_TRAIN,
        base_data_path=os.path.join(tmp, "data"),
        saved_models_path=os.path.join(tmp, "dp_gob"), **PAR_GOB_OPTS))
    out["gob"]["same"] = _same_as_rank0(models[-1], mesh)
    out["climate"] = _par_counted(lambda: ct.train(
        mesh=mesh, epochs=1, batch_size=CLIMATE_B,
        climate_dir=job["climate_dir"], hidden_size=10, dropout_rate=0.1,
        saved_models_path=os.path.join(tmp, "dp_climate"), device="cuda"))
    out["climate"]["same"] = _same_as_rank0(models[-1], mesh)
    out["group"] = _par_counted(lambda: sweeps.parallel_training(
        params=[dict(p) for p in job["conv"]], vmap_groups=True,
        group_mesh=mesh))
    return out


def _par_same_run(tag, dir_a, dir_b, mids=(1,)):
    """Two runs' artifacts bit for bit: every metric of every row but the
    times, and every tensor of both checkpoints (model and Adam state)."""
    import torch

    from njode_tpu_torch.utils.csv_frame import read_frame

    for mid in mids:
        runs = []
        for d in (dir_a, dir_b):
            cols, rows = read_frame(os.path.join(d, f"id-{mid}",
                                                 f"metric_id-{mid}.csv"))
            keep = [i for i, c in enumerate(cols)
                    if c not in ("train_time", "eval_time")]
            runs.append([[r[i] for i in keep] for r in rows])
        if runs[0] != runs[1] or not runs[0]:
            raise AssertionError(f"parallel {tag}: id {mid} rows "
                                 f"{runs[0]} != {runs[1]}")
        for slot in ("last_checkpoint", "best_checkpoint"):
            a, b = (torch.load(os.path.join(d, f"id-{mid}", slot,
                                            "checkpt.tar"),
                               weights_only=True) for d in (dir_a, dir_b))
            ta = list(a["model_state_dict"].values()) + [
                t for st in a["optimizer_state_dict"]["state"].values()
                for t in st.values()]
            tb = list(b["model_state_dict"].values()) + [
                t for st in b["optimizer_state_dict"]["state"].values()
                for t in st.values()]
            if len(ta) != len(tb) or not all(torch.equal(x, y)
                                             for x, y in zip(ta, tb)):
                raise AssertionError(f"parallel {tag}: id {mid} {slot} "
                                     "differs")
    say("parallel", run=tag, bit_equal=True, ids=list(mids))


def _par_expect_main(steps):
    return {"njode_scan_fwd": steps, "njode_scan_bwd": steps,
            "njode_scan_eval": PAR_EPOCHS, "philox_keep": 2 * steps,
            "reduce_partials": 2 * steps + PAR_EPOCHS}


def _par_rows(tag, rows, cfg, B_local):
    """Every scan launch of a rank took the rows the rule takes at its
    batch (``B_local`` for the training launches)."""
    from njode_tpu_torch.ops import fused_scan as fs

    spec = fs.Spec(cfg)
    for key, (R, _) in rows.items():
        name, B = key.rsplit("@", 1)
        if R != spec.rows_for(int(B), "bwd" in name):
            raise AssertionError(f"parallel {tag}: {key} took {R} rows")
    if not any(int(k.rsplit("@", 1)[1]) == B_local for k in rows):
        raise AssertionError(f"parallel {tag}: no launch at {B_local} "
                             f"rows: {rows}")


def phase_parallel(results):
    """Data parallelism (njode_tpu_torch/parallel/) on the one card: NCCL
    at world size 1 in this process, then two gloo ranks sharing the card
    (NCCL refuses two ranks on one device), then the kernels at one rank's
    rows timed here."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from njode_tpu_torch.data import datasets
    from njode_tpu_torch.experiments import configs
    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.parallel import sharding
    from njode_tpu_torch.training import sweeps

    tmp = tempfile.mkdtemp(prefix="njode_smoke_parallel_")
    launches = {}
    try:
        t0 = time.time()
        data = os.path.join(tmp, "data")
        datasets.create_dataset("BlackScholes", dict(
            datasets.hyperparam_default, nb_paths=20_000, obs_perc=0.1),
            seed=0, base_path=data)
        datasets.create_dataset("Heston", dict(
            datasets.hyperparam_default, nb_paths=20_000), base_path=data)
        say("parallel", datasets_s=f"{time.time() - t0:.2f}")
        steps = PAR_EPOCHS * (16_000 // PAR_B)

        # (a) NCCL at world size 1: the main path with and without a mesh
        from njode_tpu_torch.training import trainer
        sharding.initialize_distributed(
            "nccl", "file://" + os.path.join(tmp, "nccl_store"),
            world_size=1, rank=0, timeout=300)
        try:
            mesh1 = sharding.make_mesh()
            solo = _par_counted(lambda: trainer.train(
                **_par_main_kw(tmp, "solo")))
            nccl = _par_counted(lambda: trainer.train(
                mesh=mesh1, **_par_main_kw(tmp, "nccl1")))
        finally:
            dist.destroy_process_group()
        for tag, run in (("solo", solo), ("nccl1", nccl)):
            _check_counts("parallel", run["counts"], _par_expect_main(steps))
        _par_same_run("nccl1", os.path.join(tmp, "solo"),
                      os.path.join(tmp, "nccl1"))
        launches["nccl1"] = nccl["counts"]
        say("parallel", nccl1_s=f"{nccl['secs']:.2f}",
            solo_s=f"{solo['secs']:.2f}")

        # (b) two gloo ranks on the card
        conv, _ = configs.convergence_study(epochs=1,
                                            repeats=PAR_CONV_REPEATS)
        conv = [dict(p, base_data_path=data,
                     saved_models_path=os.path.join(tmp, "dp_group"))
                for p in conv
                if p["ode_nn"][0][0] == 320 and p["training_size"] == 200]
        job = dict(tmp=tmp, climate_dir=results["climate"]["dir"],
                   conv=conv)
        t0 = time.time()
        outs = sharding.spawn(parallel_rank, 2, args=(job,),
                              backend="gloo", timeout=300, wait=600)
        say("parallel", ranks=2, backend="gloo",
            spawn_s=f"{time.time() - t0:.2f}",
            runs_s=",".join(f"{k}:{outs[0][k]['secs']:.2f}" for k in (
                "main", "gob", "climate", "group")))
        errs = {}
        for kind, tol in (("njode", GRAD_TOL), ("gob", None)):
            ref_loss, ref_grads = _par_step(kind, None)
            for r, out in enumerate(outs):
                loss, grads = out[kind + "_step"]
                e_l = check_close(f"parallel {kind} loss (rank {r})", loss,
                                  ref_loss, LOSS_TOL)
                if len(grads) != len(ref_grads):
                    raise AssertionError(f"parallel {kind}: gradients")
                e_g = max(check_close(
                    f"parallel {kind} grad {i} (rank {r})", a, b,
                    tol or scaled_tol(b))
                    for i, (a, b) in enumerate(zip(grads, ref_grads)))
                errs[kind] = max(errs.get(kind, 0.0), e_l, e_g)
            say("parallel", step=kind, rows_a_rank=(PAR_B if kind == "njode"
                                                    else 20) // 2,
                max_abs_err=f"{errs[kind]:.3e}",
                loss=f"{float(ref_loss):.6f}")
        n_clim = -(-results["climate"]["n_train"] // CLIMATE_B)
        for r, out in enumerate(outs):
            tag = f"rank{r}"
            _check_counts("parallel", out["main"]["counts"],
                          _par_expect_main(steps))
            _par_rows(f"main {tag}", out["main"]["rows"],
                      results["setup"]["cfg"], PAR_B // 2)
            gob_steps = PAR_GOB_TRAIN // 20
            n = sum(out["gob"]["chunks"])
            if len(out["gob"]["chunks"]) != gob_steps:
                raise AssertionError(f"parallel gob {tag}: K6 calls")
            _check_counts("parallel", out["gob"]["counts"], {
                "gob_scan_fwd": gob_steps, "gob_bwd_remat": n,
                "gob_scan_bwd": n, "gob_bwd_wgrad": n, "gob_scan_eval": 1,
                "gob_philox_keep": gob_steps + n,
                "reduce_partials": 2 * gob_steps + 1})
            _check_counts("parallel", out["climate"]["counts"], {
                "njode_scan_fwd": n_clim, "njode_scan_bwd": n_clim,
                "philox_keep": 2 * n_clim, "reduce_partials": 2 * n_clim})
            _par_rows(f"climate {tag}", out["climate"]["rows"],
                      _masked_cfg(5, 10, 50), CLIMATE_B // 2)
            conv_steps = 200 // 20
            _check_counts("parallel", out["group"]["counts"], {
                "njode_scan_fwd_members_global": conv_steps,
                "njode_scan_bwd_members_global": conv_steps,
                "philox_keep_members": 2 * conv_steps,
                "reduce_partials_members": 2 * conv_steps,
                "njode_scan_eval_global": 2, "reduce_partials": 2})
            if out["group"]["result"] != [0] * PAR_CONV_REPEATS:
                raise AssertionError(f"parallel group {tag}: "
                                     f"{out['group']['result']}")
            if not all(out[k]["same"] for k in ("main", "gob", "climate")):
                raise AssertionError(f"parallel {tag}: parameters differ "
                                     "from rank 0's")
        say("parallel", params_equal_across_ranks=True,
            launches_per_rank=json.dumps({k: {
                c: v for c, v in outs[0][k]["counts"].items() if v}
                for k in ("main", "gob", "climate", "group")})
            .replace(" ", ""))
        # the climate arm's evaluation padded to an even batch: finite rows
        from njode_tpu_torch.utils.csv_frame import read_frame, to_float
        cols, rows = read_frame(os.path.join(tmp, "dp_climate", "id-1",
                                             "metric_id-1.csv"))
        rec = {c: to_float(v) for c, v in zip(cols, rows[-1])}
        if len(rows) != 1 or not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"parallel climate: rows {rows}")
        say("parallel", climate_row=json.dumps(rec).replace(" ", ""))
        # the 1-rank group of the same entries, bit for bit
        one = _par_counted(lambda: sweeps.parallel_training(
            params=[dict(p, saved_models_path=os.path.join(tmp, "group1"))
                    for p in conv], vmap_groups=True))
        if one["result"] != [0] * PAR_CONV_REPEATS:
            raise AssertionError(f"parallel group1: {one['result']}")
        _check_counts("parallel", one["counts"], {
            "njode_scan_fwd_members_global": conv_steps,
            "njode_scan_bwd_members_global": conv_steps,
            "philox_keep_members": 2 * conv_steps,
            "reduce_partials_members": 2 * conv_steps,
            "njode_scan_eval_global": PAR_CONV_REPEATS,
            "reduce_partials": PAR_CONV_REPEATS})
        _par_same_run("group", os.path.join(tmp, "dp_group"),
                      os.path.join(tmp, "group1"),
                      range(1, PAR_CONV_REPEATS + 1))
        for k in ("main", "gob", "climate", "group"):
            launches[k] = [out[k]["counts"] for out in outs]
        # the main path's epochs: alone, under NCCL at world size 1, and
        # over the two ranks that share the card (no speed figure: their
        # kernels take turns on it, the gradient travels through the host)
        for tag in ("solo", "nccl1", "dp_main"):
            cols, rows = read_frame(os.path.join(tmp, tag, "id-1",
                                                 "metric_id-1.csv"))
            say("parallel", run=tag, **{c: ",".join(
                f"{to_float(r[cols.index(c)]):.4f}" for r in rows)
                for c in ("train_time", "eval_time", "train_loss",
                          "eval_loss")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the kernels at one rank's rows: K1/K2 of the main path at 50 rows,
    # K5/K6 of the GOB trainer at 10, alone on the card
    dev = torch.device("cuda")
    t, bnd = {}, {}
    cfg, model, batch = main_path_setup(PAR_B // 2, 100, 3, dev)
    spec = fs.Spec(cfg, "prng")
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
              batch.start_X)
    with torch.no_grad():
        h0 = model.encoder_map(batch.start_X)
    seed = torch.tensor([20251018], dtype=torch.int64, device=dev)
    _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True, None,
                                seed)
    dloss = torch.ones((), device=dev)
    t["K1"] = (cuda_ms(lambda: fs.scan_fwd_cuda(
        spec, leaves, arrays, 0.5, h0, True, None, seed), 20),
        cuda_ms(lambda: fs.scan_fwd_plain(spec, leaves, arrays, 0.5, h0,
                                          True, None, seed), 2, 1))
    t["K2"] = (cuda_ms(lambda: fs.scan_bwd_cuda(
        spec, leaves, arrays, 0.5, True, hists, dloss, None, seed), 20),
        cuda_ms(lambda: fs.scan_bwd_plain(spec, leaves, arrays, 0.5, True,
                                          hists, dloss, None, seed), 2, 1))
    sb = _scan_bounds(spec, 100, PAR_B // 2)
    bnd["K1"], bnd["K2"] = sb["K1"], sb["K2"]
    gcfg, _, _, garrays, gleaves, st = gob_setup(10, 100, 50, True, 1e-4,
                                                 50, dev)
    gspec = fg.Spec(gcfg, "prng")
    _, ghists = fg.gob_scan_fwd_cuda(gspec, gleaves, garrays, *st, True,
                                     None, seed)
    t["K5"] = (cuda_ms(lambda: fg.gob_scan_fwd_cuda(
        gspec, gleaves, garrays, *st, True, None, seed), 10),
        cuda_ms(lambda: fg.gob_scan_fwd_plain(gspec, gleaves, garrays, *st,
                                              True, None, seed), 2, 1))
    t["K6"] = (cuda_ms(lambda: fg.gob_scan_bwd_cuda(
        gspec, gleaves, garrays, True, ghists, dloss, None, seed), 5),
        cuda_ms(lambda: fg.gob_scan_bwd_plain(gspec, gleaves, garrays, True,
                                              ghists, dloss, None, seed),
                1, 1))
    (f5, b5), (f6, b6) = gob_bounds(gspec, 100, 10)
    bnd["K5"], bnd["K6"] = bound(f5, b5, PEAK_FP32), bound(f6, b6,
                                                           PEAK_FP32)
    for k, (ms, plain) in t.items():
        say("parallel", kernel=k, rows_a_rank=PAR_B // 2 if k in (
            "K1", "K2") else 10, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bnd[k][0]:.5f}", bound_by=bnd[k][1])
    results["parallel"] = dict(errs=errs, times=t, bounds=bnd,
                               launches=launches)


# the tp phase: the main path's widths (hidden 10, three 2x50 tanh MLPs,
# dropout 0.1) at B = 100, K = 100, the model split over 2 ranks
TP_B = 100
TP_K = 100
TP_REPS = 2


def tp_setup(dev):
    """The main path's model (seeded 3) and a BlackScholes dataset of
    ``TP_B`` paths on the card, in ``make_step_fns``' layout: ``(cfg,
    model, (paths, obs, idx), (times, dts))``."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import sde
    from njode_tpu_torch.data.datasets import hyperparam_default

    cfg, model, _ = main_path_setup(TP_B, TP_K, 3, dev)
    hp = dict(hyperparam_default, nb_paths=TP_B, nb_steps=TP_K)
    paths, dt = sde.make_model("BlackScholes", hp).generate_paths(
        torch.Generator(device=dev).manual_seed(3))
    obs = torch.as_tensor((np.random.RandomState(3).random(
        (TP_B, TP_K + 1)) < 0.1).astype(np.float32), device=dev)
    times = torch.as_tensor((np.arange(1, TP_K + 1) * dt).astype(
        np.float32), device=dev)
    dts = torch.full((TP_K,), dt, dtype=torch.float32, device=dev)
    idx = torch.arange(TP_B, device=dev)
    return cfg, model, (paths.float().contiguous(), obs, idx), (times, dts)


def _tp_run(mesh):
    """The main path's model (:func:`tp_setup`), cut over the 'model' axis
    of the 2-D ``mesh`` (None: unsharded): the eval loss, one Adam step's
    loss (dropout 0.1, masks from a generator seeded 5), its gradients and
    the parameters after it (both gathered where the model is cut), and the
    ms of an eval and a step (host clock around ``TP_REPS`` of each, the
    card synchronised)."""
    import torch

    from njode_tpu_torch.parallel import sharding, tensor_parallel
    from njode_tpu_torch.training.steps import make_optimizer, make_step_fns

    dev = torch.device("cuda")
    _, model, data, grid_ = tp_setup(dev)
    opt = make_optimizer(model.parameters(), 1e-3)
    if mesh is not None:
        sharding.shard_model(model, mesh, opt)
    fns = make_step_fns(model, opt, *grid_, mesh=mesh)
    ev = float(fns["eval_loss"](*data, 0.5))
    loss = float(fns["train_step"](*data, 0.5,
                                   torch.Generator(device=dev).manual_seed(5)))
    grads = {k: p.grad for k, p in model.named_parameters()}
    params = model.state_dict()
    if mesh is not None:
        grads = tensor_parallel.full_state_dict(model, grads)
        params = tensor_parallel.full_state_dict(model)
    grads, params = ({k: v.detach().cpu().clone() for k, v in t.items()}
                     for t in (grads, params))
    ms = {}
    for tag, fn in (("eval", lambda: fns["eval_loss"](*data, 0.5)),
                    ("step", lambda: fns["train_step"](
                        *data, 0.5, torch.Generator(device=dev).manual_seed(
                            6)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_REPS):
            fn()
        torch.cuda.synchronize()
        ms[tag] = (time.perf_counter() - t0) * 1e3 / TP_REPS
    return dict(eval=ev, loss=loss, grads=grads, params=params, ms=ms)


def tp_rank(mesh, job):
    """One of the tp phase's two gloo ranks sharing the card, in a process
    of its own (``parallel.sharding.spawn`` imports this script by name):
    the main path's model split over the 2-way 'model' axis of a 1 x 2
    mesh, its eval, one step and their times."""
    import torch

    from njode_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    return _tp_run(sharding.make_mesh_2d(mesh.size,
                                         model_parallel=mesh.size))


def phase_tp_eager(results):
    """Tensor parallelism (parallel/tensor_parallel.py): the main path's
    model split over two gloo ranks sharing the card against the unsharded
    eager run. It launches none of the kernels, so it runs while nvcc
    builds them: its ms beside nvcc."""
    import torch

    from njode_tpu_torch.bench import card_line
    from njode_tpu_torch.parallel import sharding

    t0 = time.time()
    outs = sharding.spawn(tp_rank, 2, args=({},), backend="gloo",
                          timeout=300, wait=600)
    spawn_s = time.time() - t0
    ref = _tp_run(None)
    errs = {}
    for r, out in enumerate(outs):
        e_ev = abs(out["eval"] - ref["eval"]) / abs(ref["eval"])
        if e_ev > 1e-5:
            raise AssertionError(f"tp eval (rank {r}): {out['eval']} vs "
                                 f"{ref['eval']}")
        if abs(out["loss"] - ref["loss"]) > 1e-4 * max(1.0, abs(ref["loss"])):
            raise AssertionError(f"tp step loss (rank {r}): {out['loss']} "
                                 f"vs {ref['loss']}")
        # Adam's first step moves a parameter by about lr * sign(gradient):
        # the gradients themselves show one off by a constant factor
        e_g = max(check_close(f"tp grads {k} (rank {r})", out["grads"][k],
                              v, GRAD_TOL)
                  for k, v in ref["grads"].items())
        e_p = max(check_close(f"tp params {k} (rank {r})", out["params"][k],
                              v, dict(rtol=1e-4, atol=1e-6))
                  for k, v in ref["params"].items())
        errs[r] = dict(eval_rel=e_ev, loss_abs=abs(out["loss"] - ref["loss"]),
                       grads_abs=e_g, params_abs=e_p)
    if not all(torch.equal(outs[0]["params"][k], outs[1]["params"][k])
               for k in ref["params"]):
        raise AssertionError("tp: the two model ranks' gathered parameters "
                             "differ")
    card = card_line()
    say("tp", mp=2, B=TP_B, K=TP_K, spawn_s=f"{spawn_s:.2f}",
        errs=json.dumps(errs).replace(" ", ""), params_equal_across_ranks=True)
    for tag in ("eval", "step"):
        say("tp", timing=tag, tp_ms=f"{outs[0]['ms'][tag]:.3f}",
            unsharded_ms=f"{ref['ms'][tag]:.3f}", card=f"'{card}'",
            beside_nvcc=True)
    results["tp"] = dict(errs=errs, ms={"tp": outs[0]["ms"],
                                        "unsharded": ref["ms"]})


def phase_tp(results):
    """The entry points (njode_tpu_torch/entry.py): the flagship's loss
    through ``entry()`` (one K1 launch) and the dry run over two gloo ranks
    sharing the card (tensor parallelism itself: ``phase_tp_eager``)."""
    import numpy as np
    import torch

    from njode_tpu_torch import entry
    from njode_tpu_torch.ops import fused_scan as fs

    t0 = time.time()
    fn, args = entry.entry()
    fs.reset_launch_counts()
    with torch.no_grad():
        loss = float(fn(*args))
    torch.cuda.synchronize()
    counts = {k: v for k, v in fs.LAUNCHES.items() if v}
    if not np.isfinite(loss) or counts.get("njode_scan_fwd") != 1:
        raise AssertionError(f"tp entry: loss {loss}, launches {counts}")
    say("tp", entry_loss=f"{loss:.6f}", launches=json.dumps(counts)
        .replace(" ", ""), entry_s=f"{time.time() - t0:.2f}")
    t0 = time.time()
    dry = entry.dryrun_multichip(2)
    expect = {"njode_scan_fwd": 2, "njode_scan_bwd": 2, "njode_scan_eval": 1}
    got = {k: dry["launches"].get(k, 0) for k in expect}
    if got != expect:
        raise AssertionError(f"tp dryrun: rank 0 launched {dry['launches']}")
    say("tp", dryrun_s=f"{time.time() - t0:.2f}",
        dryrun_launches_rank0=json.dumps(dry["launches"]).replace(" ", ""))
    results["tp"].update(entry=counts, dryrun=dry["launches"])


# ---------------------------------------------------------------------------
# the sequential GRU-ODE-Bayes, the C++ collation, mixed precision, the
# width study and profiling
# ---------------------------------------------------------------------------

SEQ_CFG = dict(input_size=5, hidden_size=50, p_hidden=25, prep_hidden=10,
               cov_size=5, cov_hidden=50, mixing=1e-4, full_gru_ode=True)
WIDTHS = (50, 100, 200, 400)      # the width study's widths (hidden 50)
WIDTH_PATHS = 2000                # one epoch of 10 steps at B = 200


def _seq_run(m, b):
    """One forward and backward of ``seq_forward``: (loss, {name: grad})."""
    from njode_tpu_torch.models import gru_ode_bayes as gob

    m.zero_grad(set_to_none=True)
    loss = gob.seq_forward(m, b)[1]
    loss.backward()
    return loss.detach(), {k: p.grad.detach()
                           for k, p in m.named_parameters()
                           if p.grad is not None}


def seq_cpu_job(src, dst):
    """The CPU reference of ``phase_seq_gob``, in a process of its own:
    loads the model and batch ``src`` wrote, saves (loss, grads, ms)."""
    import torch

    from njode_tpu_torch.data.grid import GridBatch
    from njode_tpu_torch.models import gru_ode_bayes as gob

    st = torch.load(src, weights_only=True)
    model = gob.SeqGOB(gob.SeqConfig(**SEQ_CFG))
    model.load_state_dict(st["model"])
    t0 = time.perf_counter()
    loss, grads = _seq_run(model, GridBatch(*st["batch"]))
    torch.save({"loss": loss, "grads": grads,
                "ms": 1e3 * (time.perf_counter() - t0)}, dst + ".tmp")
    os.replace(dst + ".tmp", dst)


def start_seq_cpu(results, tmp):
    """Seed the sequential GRU-ODE-Bayes and its batch (the first climate
    batch, seeded covariates), and start its CPU reference run in a child
    process (``chip_smoke.py --seq-cpu``, no card), which works while the
    phases before ``seq_gob`` use the card."""
    import subprocess

    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob

    g = torch.Generator().manual_seed(14)
    cfg = gob.SeqConfig(**SEQ_CFG)
    model = gob.SeqGOB(cfg, generator=g)
    full = results["climate"]["batch"]
    cov = torch.randn((full.obs.shape[1], cfg.cov_size), generator=g)
    batch = full._replace(start_X=cov.to(full.obs.device))
    src = os.path.join(tmp, "seq_in.pt")
    dst = os.path.join(tmp, "seq_out.pt")
    torch.save({"model": model.state_dict(),
                "batch": tuple(t.cpu() for t in batch)}, src)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seq-cpu", src, dst],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    results["seq_cpu"] = dict(proc=proc, dst=dst, model=model, batch=batch)


def phase_seq_gob(results):
    """The sequential GRU-ODE-Bayes (``gru_ode_bayes.SeqGOB``) at the
    climate GOB arm's widths on the first climate batch (B = 100, K =
    2,004, seeded covariates): one forward and backward on the card,
    CUDA-event timed, finite, and held to the same run on the CPU (run by
    the child process ``start_seq_cpu`` started; loss ``LOSS_TOL``, each
    gradient leaf ``scaled_tol`` of its own values)."""
    import torch

    job = results.pop("seq_cpu")
    model = job["model"].to(torch.device("cuda"))
    full, batch = results["climate"]["batch"], job["batch"]
    (loss, grads), ms = timed(lambda: _seq_run(model, batch))
    if job["proc"].wait(timeout=600) != 0:
        raise AssertionError("seq_gob: the CPU reference run failed")
    ref = torch.load(job["dst"], weights_only=True)
    loss_c, grads_c, cpu_ms = ref["loss"], ref["grads"], ref["ms"]
    if not (torch.isfinite(loss) and all(torch.isfinite(v).all()
                                         for v in grads.values())):
        raise AssertionError("seq_gob: non-finite loss or gradient")
    if set(grads) != set(grads_c):
        raise AssertionError("seq_gob: the card and the CPU reached "
                             "different parameters")
    e_loss = check_close("seq_gob loss", loss.cpu(), loss_c, LOSS_TOL)
    used = 0.0
    for k, gc in grads_c.items():
        tol = scaled_tol(gc)
        check_close(f"seq_gob gradient {k}", grads[k].cpu(), gc, tol)
        gap = (grads[k].cpu() - gc).abs() / (tol["atol"]
                                              + tol["rtol"] * gc.abs())
        used = max(used, float(gap.max()))
    K, B = full.obs.shape
    say("seq_gob", K=K, B=B, loss=f"{float(loss):.6f}",
        loss_err=f"{e_loss:.3e}", grad_tol_used=f"{used:.3e}",
        card_ms=f"{ms:.1f}", cpu_ms=f"{cpu_ms:.1f}",
        n_params=sum(p.numel() for p in model.parameters()))
    results["seq_gob"] = dict(ms=ms, cpu_ms=cpu_ms)


def _arrays(obj):
    """Every numpy array in a (nested) collation output, in order."""
    import numpy as np

    if isinstance(obj, np.ndarray):
        return [obj]
    if isinstance(obj, dict):
        return [a for k in sorted(obj) for a in _arrays(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [a for v in obj for a in _arrays(v)]
    return []


@contextlib.contextmanager
def native_union_grid():
    """Inside the block the set-up builds its padded union grids with the
    C++ collation (``native.build_union_grid``) in place of the numpy
    ``grid.build_union_grid``, which ``data/grid.py`` and
    ``data/physionet.py`` call; grids without ``max_steps`` stay numpy."""
    from njode_tpu_torch import native
    from njode_tpu_torch.data import grid
    from njode_tpu_torch.data import physionet as pdu

    plain = grid.build_union_grid

    def union(obs_times, delta_t, T, max_steps=None):
        if max_steps is None:
            return plain(obs_times, delta_t, T)
        return native.build_union_grid(obs_times, delta_t, T, max_steps)[:3]

    grid.build_union_grid = pdu.build_union_grid = union
    try:
        yield
    finally:
        grid.build_union_grid = pdu.build_union_grid = plain


def phase_native(results):
    """The climate and PhysioNet set-up at the published scale with their
    union grids from the C++ collation (``njode_tpu_torch/native``,
    :func:`native_union_grid`) and from numpy, the port's path: fold 0's
    pre-stacked training bank, the test split as one sparse batch, an
    epoch's training batches as sparse batches and one dense batch
    (climate, B = 100), and the PhysioNet pre-stacked bank and test batch;
    the outputs bit for bit, and the dense batch's scatter
    (``native.densify_events``) bit for bit numpy's. Run after the build,
    with the host otherwise idle: numpy, native, numpy, native, the
    seconds of each."""
    import numpy as np

    from njode_tpu_torch import native
    from njode_tpu_torch.data import climate as cdu
    from njode_tpu_torch.data import grid
    from njode_tpu_torch.data import physionet as pdu
    from njode_tpu_torch.training import climate_trainer as ct
    from njode_tpu_torch.training.physionet_trainer import _events

    t0 = time.perf_counter()
    native.get_lib()
    say("native", build_s=f"{time.perf_counter() - t0:.2f}")
    cdir = results["climate"]["dir"]
    csv = os.path.join(cdir, "small_chunked_sporadic.csv")
    fold = os.path.join(cdir, "small_chunk_fold_idx_0")
    train_idx = np.load(os.path.join(fold, "train_idx.npy"))
    test_idx = np.load(os.path.join(fold, "test_idx.npy"))
    data = pdu.parse_datasets("", records=results["phys"]["records"])
    tr, te = data["train_records"], data["test_records"]
    dmin, dmax = data["data_min"], data["data_max"]
    delta_p = PHYS_QUANT / 48.0

    def climate():
        ds = cdu.ClimateDataset(csv, idx=train_idx)
        tst = cdu.ClimateDataset(csv, idx=test_idx)
        K = max(ds.max_grid_steps(0.1, 200.0), tst.max_grid_steps(0.1,
                                                                  200.0))
        pre = cdu.prestack_series(ds, 0.1, 200.0, K)
        ev = tst.collate(np.arange(len(tst)))
        test = grid.sparse_from_events(ev, 0.1, 200.0, K,
                                       max_events=len(ev["obs_idx"]))
        idx_mat, _, _ = ct.epoch_batches(398, 1, len(ds), CLIMATE_B)
        emax = ds.max_batch_events(CLIMATE_B)
        # the batches without the sentinel rows that pad the last one
        epoch = [grid.sparse_from_events(ds.collate(idx[idx < len(ds)]),
                                         0.1, 200.0, K, max_events=emax)
                 for idx in idx_mat]
        dense = cdu.dense_batch_from_events(ds.collate(idx_mat[0]), 0.1,
                                            200.0, K)
        return [pre, test, epoch, dense]

    def physionet():
        K = pdu.max_union_grid_steps(tr + te, delta_p, PHYS_T)
        pre = pdu.prestack_train_records(tr, dmin, dmax, delta_p, PHYS_T, K)
        tc = _events(pdu.collate_records(te, dmin, dmax, data_type="test"))
        test = grid.sparse_from_events(tc, delta_p, PHYS_T, K,
                                       max_events=len(tc["obs_idx"]))
        return [pre, test]

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))

    out = {}
    for name, fn in (("climate", climate), ("physionet", physionet)):
        got = {}
        for nat in (False, True, False, True):
            with (native_union_grid() if nat else contextlib.nullcontext()):
                t0 = time.perf_counter()
                res = fn()
                got.setdefault(nat, []).append(
                    (time.perf_counter() - t0, _arrays(res)))
        if not same(got[True][0][1], got[False][0][1]):
            raise AssertionError(f"native {name}: the C++ collation "
                                 "differs from the numpy paths")
        secs = {nat: [t for t, _ in got[nat]] for nat in got}
        out[name] = dict(native_s=secs[True], numpy_s=secs[False])
        say("native", setup=name, arrays=len(got[True][0][1]),
            bit_equal=True,
            native_s=",".join(f"{t:.3f}" for t in secs[True]),
            numpy_s=",".join(f"{t:.3f}" for t in secs[False]))
    # the dense climate batch's scatter, C++ against numpy
    ds = cdu.ClimateDataset(csv, idx=train_idx)
    ev = ds.collate(np.arange(CLIMATE_B))
    K = ds.max_grid_steps(0.1, 200.0)
    b = grid.batch_from_events(ev["times"], ev["time_ptr"], ev["X"],
                               ev["obs_idx"], 0.1, 200.0,
                               np.zeros((CLIMATE_B, ev["X"].shape[1]),
                                        np.float32),
                               M=ev["M"], max_steps=K)
    _, _, obs_step, _ = native.build_union_grid(ev["times"], 0.1, 200.0, K)
    nat = native.densify_events(obs_step, ev["time_ptr"], ev["obs_idx"],
                                ev["X"], np.asarray(ev["M"], np.float32), K,
                                CLIMATE_B)
    if not same(list(nat), [b.obs, b.X, b.M]):
        raise AssertionError("native: densify_events differs from "
                             "grid.batch_from_events")
    say("native", densify_events="bit_equal", K=K, B=CLIMATE_B)
    results["native"] = out


def bf16_grad_check():
    """The gradients of one bf16 training step (eager, dropout 0) at the
    study's bench shape (B = 200, K = 100, width 50, hidden 10) on the card
    against the same step on the CPU with the card's rounding. On the card
    each operand gradient's product takes the float32 cotangent rounded to
    bfloat16 (torch.mm with out_dtype takes two bf16 operands), as the JAX
    package's TPU dots do at their default precision; the CPU route keeps
    it float32, as the JAX package's CPU dots do (the tests hold that route
    to jax.grad). The reference swaps ``mlp._mm_bf16`` for that rounding on
    the CPU. Relative L2 error of the flat gradient, held to
    ``BF16_GRAD_TOL``; the CPU route's and the float32 step's gradients
    must lie further than that from the reference."""
    import torch

    from njode_tpu_torch.experiments import mixed_precision_study as mps
    from njode_tpu_torch.models import mlp, njode

    _, B, K, D, W, H = mps.SHAPES[0]

    def card_rounding(a, b):
        return a.to(torch.bfloat16).float() @ b.float()

    def step(cd, device, mm=None):
        nn = ((W, "tanh"),)
        cfg = njode.NJODEConfig(input_size=D, hidden_size=H, output_size=D,
                                ode_nn=nn, readout_nn=nn, enc_nn=nn,
                                dropout_rate=0.0, compute_dtype=cd)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            model = njode.NJODE(cfg)
        model = model.to(device)
        plain = mlp._mm_bf16
        if mm is not None:
            mlp._mm_bf16 = mm
        try:
            _, loss = njode.forward(model, mps.make_batch(B, K, D, device),
                                    train=True)
            loss.backward()
        finally:
            mlp._mm_bf16 = plain
        g = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
        return g.double().cpu(), float(loss.detach())

    ref, l_ref = step("bfloat16", "cpu", card_rounding)
    card, l_card = step("bfloat16", "cuda")

    def rel(g):
        return float((g - ref).norm() / ref.norm())

    err = {"card": rel(card), "cpu_route": rel(step("bfloat16", "cpu")[0]),
           "float32": rel(step("float32", "cpu")[0])}
    say("mixed_precision", grad_check=f"B={B},K={K},width={W}",
        tol=BF16_GRAD_TOL, **{k: f"{v:.3e}" for k, v in err.items()},
        loss_rel=f"{abs(l_card - l_ref) / abs(l_ref):.3e}")
    if not (err["card"] <= BF16_GRAD_TOL < min(err["cpu_route"],
                                               err["float32"])):
        raise AssertionError(f"mixed_precision: bf16 gradients on the card "
                             f"{err} (relative L2 against the CPU with the "
                             f"card's rounding, tolerance {BF16_GRAD_TOL})")
    if not abs(l_card - l_ref) <= BF16_GRAD_TOL * abs(l_ref):
        raise AssertionError(f"mixed_precision: bf16 loss on the card "
                             f"{l_card} against {l_ref}")


def phase_mixed_precision(results):
    """compute_dtype='bfloat16' on the card: the bf16 product against its
    plain form on the CPU, then the mixed-precision study's three shapes
    (``experiments/mixed_precision_study.py``, 2 steps each way) in float32
    and bfloat16; no scan kernel may launch (bf16 takes the eager forward),
    and each bf16 loss must lie within 2e-2 relative of the float32 one.
    Before them, one bf16 step's gradients on the card against the CPU
    (:func:`bf16_grad_check`).
    Beside them, one product at the wide shapes in float32 and on the
    bf16 route, CUDA-event timed."""
    import torch

    from njode_tpu_torch.experiments import mixed_precision_study as mps
    from njode_tpu_torch.models import mlp
    from njode_tpu_torch.ops import fused_scan as fs

    g = torch.Generator().manual_seed(5)
    x = torch.randn(300, 257, generator=g)
    w = torch.randn(129, 257, generator=g)
    before = dict(mlp.BF16_ROUTES)
    y_cpu = mlp.bf16_matmul(x, w)
    y = mlp.bf16_matmul(x.cuda(), w.cuda())
    routes = {k: v - before[k] for k, v in mlp.BF16_ROUTES.items()}
    err = max_err(y.cpu(), y_cpu) / float(y_cpu.abs().max())
    rounded = bool(torch.equal(y, y.to(torch.bfloat16).float()))
    if y.dtype != torch.float32 or rounded or err > 1e-5:
        raise AssertionError(f"mixed_precision: the bf16 product on the card "
                             f"({y.dtype}, rounded to bf16: {rounded}, "
                             f"rel err {err:.3e}) is not JAX's")
    say("mixed_precision", product_rel_err=f"{err:.3e}",
        fp32_output=True, route=json.dumps(routes).replace(" ", ""))
    bf16_grad_check()
    # one product at the wide shapes' activations: float32 (TF32 off)
    # against the bf16 route, and a bf16-output matmul for reference
    for n, k in ((2048, 512), (4096, 1024), (8192, 1024)):
        a = torch.randn(n, k, device="cuda")
        b = torch.randn(k, k, device="cuda")
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ms32 = cuda_ms(lambda: a @ b, 20)
        ms16 = cuda_ms(lambda: torch.mm(ab, bb, out_dtype=torch.float32), 20)
        ms_bf = cuda_ms(lambda: ab @ bb, 20)
        say("mixed_precision", gemm=f"[{n},{k}]x[{k},{k}]",
            fp32_ms=f"{ms32:.4f}", bf16_to_fp32_ms=f"{ms16:.4f}",
            bf16_to_bf16_ms=f"{ms_bf:.4f}", speedup=f"{ms32 / ms16:.2f}",
            bf16_tflops=f"{2 * n * k * k / ms16 / 1e9:.1f}")
    fs.reset_launch_counts()
    before = dict(mlp.BF16_ROUTES)
    rows = mps.run(reps=2, warmup=1,
                   log=lambda ln: print("[mixed_precision] " + ln,
                                        flush=True))
    torch.cuda.synchronize()
    _check_counts("mixed_precision", dict(fs.LAUNCHES), {})
    routes = {k: v - before[k] for k, v in mlp.BF16_ROUTES.items()}
    if routes[mlp._CPU_ROUTE] or not routes[mlp._CUDA_ROUTE]:
        raise AssertionError(f"mixed_precision: bf16 routes {routes}")
    for r in rows:
        l32, l16 = r["float32"]["loss"], r["bfloat16"]["loss"]
        rel = abs(l16 - l32) / abs(l32)
        if not rel < 2e-2:
            raise AssertionError(f"mixed_precision {r['tag']}: bf16 loss "
                                 f"{l16} vs fp32 {l32} ({rel:.3e})")
        say("mixed_precision", tag=r["tag"], B=r["B"], K=r["K"],
            width=r["width"], hidden=r["hidden"],
            fp32_step_ms=f"{1e3 * r['float32']['piped_step_s']:.2f}",
            bf16_step_ms=f"{1e3 * r['bfloat16']['piped_step_s']:.2f}",
            speedup=f"{r['speedup']:.3f}", loss_rel_diff=f"{rel:.3e}")
    say("mixed_precision", route=json.dumps(routes).replace(" ", ""))
    results["mixed_precision"] = rows


def phase_width_scaling(results):
    """The width study's model (hidden 50, three 2 x width tanh MLPs,
    dropout 0.1, 'prng') at widths 50-400 on its own draws: one epoch of
    2,000 paths at B = 200 through ``make_step_fns`` with exact launch
    counts at the rule's rows, then K1/K2 (and K3) at that width's shape
    (B = 200, K = 100) against their plain versions in 'input' mode, each
    twice bit for bit (``SHORT_TOL``), with their times and bounds."""
    import numpy as np
    import torch

    from njode_tpu_torch.experiments import width_scaling as ws
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training.steps import make_optimizer, make_step_fns

    dev = torch.device("cuda")
    N, B, K = WIDTH_PATHS, 200, ws.K_STEPS
    paths, obs = ws._sim_paths(N)
    d_paths = torch.as_tensor(paths, device=dev)
    d_obs = torch.as_tensor(obs, device=dev)
    times = torch.as_tensor((np.arange(1, K + 1) * ws.DT).astype(np.float32),
                            device=dev)
    dts = torch.full((K,), ws.DT, dtype=torch.float32, device=dev)
    idx_mat = torch.as_tensor(np.random.RandomState(3).permutation(N)
                              .reshape(N // B, B), device=dev)
    steps = N // B
    gen = torch.Generator(device=dev).manual_seed(12)
    launches, worst = [], {p: {"K1m": 0.0, "K2m": 0.0, "K3m": 0.0}
                           for p in ("resident", "global")}
    for width in WIDTHS:
        cfg = ws._cfg(width, 50)
        plan = ws.kernel_plan(cfg, B)
        if plan is None:
            raise AssertionError(f"width_scaling: width {width} is outside "
                                 "the kernels")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = njode.NJODE(cfg).to(dev)
        fns = make_step_fns(model, make_optimizer(model.parameters(), 1e-3),
                            times, dts, use_kernels=True)
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        losses = fns["train_epoch"](d_paths, d_obs, idx_mat, 0.5,
                                    torch.Generator(device=dev)
                                    .manual_seed(2))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = dict(fs.LAUNCHES)
        g = "_global" if plan[0] == "global" else ""
        _check_counts("width_scaling", counts, {
            "njode_scan_fwd" + g: steps, "njode_scan_bwd" + g: steps,
            "philox_keep": 2 * steps, "reduce_partials": 2 * steps})
        check_rows("width_scaling", cfg)
        launches.append(counts)
        if not torch.isfinite(losses).all():
            raise AssertionError(f"width_scaling {width}: non-finite loss")
        say("width_scaling", width=width, plan=plan[0], rows_K1=plan[1],
            rows_K2=plan[2], epoch_s=f"{epoch_s:.3f}", steps=steps,
            paths_per_s=f"{N / epoch_s:.1f}",
            last_loss=f"{float(losses[-1]):.6f}")
        cfg2, model2, batch = main_path_setup(B, K, 3, dev, width=width,
                                              hidden=50)
        errs, _, _ = _masked_arm_checks(
            "width_scaling", cfg2, model2, batch,
            ((K, ("input",), SHORT_TOL),), gen, arm=f"w{width}")
        for k, v in errs.items():
            worst[plan[0]][k] = max(worst[plan[0]][k], v)
        ms, bd, Kt, Bt, spec = _full_grid_times(cfg2, model2, batch, 3)
        _say_times("width_scaling", f"w{width}", spec, ms, bd, Kt, Bt)
    say("width_scaling", errs=json.dumps(worst).replace(" ", ""))
    results["width"] = dict(launches=launches, errs=worst)


# the scope phase: E3b's arms (the linears of the ODE net and its width;
# the others keep the main path's 2 x 50, so the deepest arm of width 10
# runs in the resident plan, the ODE net's 100 hidden phases beside the
# encoder's two; whether a trainer epoch runs, else the fused loss and
# eval functions once), the paths of its dataset (800 training paths: 8
# steps an epoch at B = 100, the rest the eval's), E3a's arms (id, data,
# output width, GRU jump, plan: None the rule's, the global plan at 16
# rows; or the global plan forced to one row, the resident plan's rows at
# B = 100: such a config has the global plan alone) and E3c's training
# paths (20 steps an epoch at B = 20)
SCOPE_DEEP = ((9, 50, True), (16, 50, True), (33, 50, True),
              (65, 50, True), (101, 10, False))
SCOPE_PATHS = 1000
SCOPE_OUT = (("hwof_D2_O1", ("HestonWOFeller", HWOF_RV), 1, False, None),
             ("bs_D1_O2", BS, 2, False, ("global", 1)),
             ("hwof_D2_O1_rnn", ("HestonWOFeller", HWOF_RV), 1, True,
              ("global", 1)),
             ("bs_D1_O2_rnn", BS, 2, True, None))
SCOPE_GOB_TRAIN = 400
SCOPE_P = 4000


def _scope_deep(results, tmp, gen, out):
    """E3b: the main path's model with an ODE net of each of
    ``SCOPE_DEEP``'s depths (no cap since the layer table): one epoch
    through ``trainer.train`` with exact launch counts (at 101 linears one
    training loss and its gradients through ``make_fused_loss_fn`` and an
    eval loss through ``make_fused_eval_fn``, exact launch counts), then
    K1-K3 at B = 100, K = 100 against their plain versions ('input' mode,
    each twice bit for bit), and every arm timed."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    steps = int(0.8 * SCOPE_PATHS) // 100
    for n_lin, width, epoch in SCOPE_DEEP:
        arm = f"deep{n_lin}"
        ode = ((width, "tanh"),) * (n_lin - 1)
        cfg, model, batch = main_path_setup(100, 100, n_lin, dev, ode_nn=ode)
        spec = fs.Spec(cfg)
        g = fs._launch_key(spec)
        t0 = time.time()
        if epoch:
            counts = _synthetic_run(tmp, f"scope_{arm}", epochs=1,
                                    ode_nn=ode)
            _check_counts("scope", counts, {
                "njode_scan_fwd" + g: steps, "njode_scan_bwd" + g: steps,
                "njode_scan_eval" + g: 1, "philox_keep": 2 * steps,
                "reduce_partials": 2 * steps + 1})
        else:
            fs.reset_launch_counts()
            loss = fs.make_fused_loss_fn(cfg, "prng")(model, batch, 0.5, gen,
                                                     True)
            loss.backward()
            ev = fs.make_fused_eval_fn(cfg)(model, batch, 0.5)
            torch.cuda.synchronize()
            counts = dict(fs.LAUNCHES)
            _check_counts("scope", counts, {
                "njode_scan_fwd" + g: 1, "njode_scan_bwd" + g: 1,
                "njode_scan_eval" + g: 1, "philox_keep": 2,
                "reduce_partials": 3})
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            if not (torch.isfinite(loss) and torch.isfinite(ev) and all(
                    torch.isfinite(x).all() for x in grads)):
                raise AssertionError(f"scope {arm}: non-finite loss or "
                                     "grads")
            model.zero_grad(set_to_none=True)
        check_rows("scope", cfg)
        out["launches"][arm] = counts
        errs, plain, _ = _masked_arm_checks(
            "scope", cfg, model, batch, ((100, ("input",), SHORT_TOL),), gen,
            arm=arm)
        out["errs"][arm] = errs
        ms, bd, K, B, spec = _full_grid_times(cfg, model, batch, 3)
        _say_times("scope", arm, spec, ms, bd, K, B)
        out["times"][arm] = {k: (ms[k], plain[k + "m"])
                             for k in ("K1", "K2", "K3")}
        out["bounds"][arm] = bd
        say("scope", arm=arm, width=width, plan=spec.plan,
            rows=spec.rows_for(100), n_params=spec.n_params,
            smem_bytes=spec.smem_bytes, table_ints=spec.tab_ints,
            trainer_epoch=epoch, seconds=f"{time.time() - t0:.2f}",
            **{f"{k}_plain_ms": f"{plain[k + 'm']:.4f}"
               for k in ("K1", "K2", "K3")})


def _scope_out(results, gen, out):
    """E3a: an unmasked output of another width than the input (the
    HestonWOFeller return_vol data, D = 2, with O = 1; BlackScholes, D = 1,
    with O = 2), with the encoder and the GRU jump, in the global plan (the
    only one such a config has) at the rule's 16 rows and at one: a
    training loss and its gradients through
    ``make_fused_loss_fn`` and an eval loss through ``make_fused_eval_fn``
    at B = 100, K = 100 with exact launch counts, then K1-K3 against their
    plain versions (each twice bit for bit); the first arm timed."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    for i, (arm, data, O, rnn, plan) in enumerate(SCOPE_OUT):
        cfg, model, batch = main_path_setup(100, 100, 20 + i, dev,
                                            use_rnn=rnn, data=data,
                                            output_size=O)
        if not fs.supported(cfg) or cfg.output_size == cfg.input_size:
            raise AssertionError(f"scope {arm}: not an E3a config")
        spec = fs.Spec(cfg, "prng", plan)
        if spec.plan != "global":
            raise AssertionError(f"scope {arm}: not in the global plan")
        g = fs._launch_key(spec)
        fs.reset_launch_counts()
        loss = fs.make_fused_loss_fn(cfg, "prng", plan=plan)(
            model, batch, 0.5, gen, True)
        loss.backward()
        ev = fs.make_fused_eval_fn(cfg, plan=plan)(model, batch, 0.5)
        torch.cuda.synchronize()
        counts = dict(fs.LAUNCHES)
        _check_counts("scope", counts, {
            "njode_scan_fwd" + g: 1, "njode_scan_bwd" + g: 1,
            "njode_scan_eval" + g: 1, "philox_keep": 2,
            "reduce_partials": 3})
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not (torch.isfinite(loss) and torch.isfinite(ev) and all(
                torch.isfinite(x).all() for x in grads)):
            raise AssertionError(f"scope {arm}: non-finite loss or grads")
        model.zero_grad(set_to_none=True)
        out["launches"]["out"].append(counts)
        errs, plain, _ = _masked_arm_checks(
            "scope", cfg, model, batch, ((100, ("input",), SHORT_TOL),), gen,
            plan=plan, arm=arm)
        for k, v in errs.items():
            out["errs"]["out"][k] = max(out["errs"]["out"][k], v)
        say("scope", arm=arm, D=cfg.input_size, O=O, use_rnn=rnn,
            plan=spec.plan, rows=spec.rows_for(100),
            train_loss=f"{float(loss.detach()):.6f}",
            eval_loss=f"{float(ev):.6f}")
        if i == 0:
            ms, bd, K, B, spec = _full_grid_times(cfg, model, batch, 5, plan)
            _say_times("scope", arm, spec, ms, bd, K, B)
            out["times"]["out"] = {k: (ms[k], plain[k + "m"])
                                   for k in ("K1", "K2", "K3")}
            out["bounds"]["out"] = bd
            say("scope", arm=arm, **{f"{k}_plain_ms": f"{plain[k + 'm']:.4f}"
                                     for k in ("K1", "K2", "K3")})


def _gob_outputs(spec, spec_e, leaves, arrays, st, seed):
    """K5's loss and histories, K6's gradients and d(h0, m0, v0) ('prng'
    masks) and the eval form's loss."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    lk, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, True, None,
                                  seed)
    g = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk,
                             torch.ones((), device=lk.device), None, seed)
    le, _ = fg.gob_scan_fwd_cuda(spec_e, leaves, arrays, *st, False,
                                 want_hists=False)
    return [lk, *hk, *g[0], *g[1:], le]


def _scope_gob(results, tmp, gen, out):
    """E3c: GOB at p_hidden 4,000 (D = 1, hidden 10, prep 10, full field,
    impute, mixing 1e-4), whose buffers of one row overflow one CTA's shared
    memory: one epoch through the synthetic trainer (the device-memory
    form, exact launch counts), K5, its eval form and K6 at B = 20, K = 100
    against their plain versions (each twice bit for bit) and timed, K6's
    stages by device time; then the device-memory form forced at the
    published hidden 50, bit for bit the shared form."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    dev = torch.device("cuda")
    t0 = time.time()
    counts = _gob_run(tmp, "scope_gob", epochs=1,
                      train_size=SCOPE_GOB_TRAIN, hidden=10,
                      gob_opts={"GRU_ODE_Bayes-p_hidden": SCOPE_P,
                                "GRU_ODE_Bayes-prep_hidden": 10})
    out["launches"]["gob"] = counts
    say("scope", arm="gob_p4000_trainer", seconds=f"{time.time() - t0:.2f}")
    B, K = 20, 100
    cfg, _, _, arrays, leaves, st = gob_setup(B, K, 10, True, 1e-4, 5, dev,
                                              p_hidden=SCOPE_P, prep=10)
    spec = fg.Spec(cfg, "input")
    if spec.acts_for() != "global" or spec.rows_for(B) != 1:
        raise AssertionError("scope: p_hidden 4,000 is not in the "
                             "device-memory form")
    u = (torch.rand((K, 3, B, spec.P), generator=gen, device=dev)
         < 0.9).to(torch.int8)
    e, plain, hk = _gob_checks(spec, leaves, arrays, st, u, None, "input",
                               arm="p4000")
    spec_e = fg.Spec(cfg, "input")
    le = [fg.gob_scan_fwd_cuda(spec_e, leaves, arrays, *st, False,
                               want_hists=False)[0] for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(le[0], le[1]):
        raise AssertionError("scope: the GOB eval form differs between runs")
    (lep, _), plain_e = timed(lambda: fg.gob_scan_fwd_plain(
        spec_e, leaves, arrays, *st, False, want_hists=False))
    e_eval = check_close("scope p4000 eval", le[0], lep, LOSS_TOL)
    out["errs"]["gob"] = {"K5": max(e["loss"], e["hist"]),
                          "K5e": e_eval,
                          "K6": max(e["grad"], e["d0"])}
    say("scope", arm="p4000", B=B, K=K, slab_classes=spec.slab_classes,
        slab_floats=spec.slab_floats(), smem_bytes=spec.smem_bytes(1),
        K5_loss_err=f"{e['loss']:.3e}", K5_hist_err=f"{e['hist']:.3e}",
        K6_grad_err=f"{e['grad']:.3e}", K6_grad_rel=f"{e['grad_rel']:.3e}",
        K6_d0_err=f"{e['d0']:.3e}", eval_err=f"{e_eval:.3e}",
        chunks=-(-K // spec.bwd_chunk(K, B)), bitwise_repeat=True)
    # timing in 'prng' mode, as the trainer runs it
    sp = fg.Spec(cfg, "prng")
    seed = torch.tensor([20261018], dtype=torch.int64, device=dev)
    fwd = lambda: fg.gob_scan_fwd_cuda(sp, leaves, arrays, *st,  # noqa
                                       True, None, seed)
    _, hists = fwd()
    dloss = torch.ones((), device=dev)
    bwd = lambda: fg.gob_scan_bwd_cuda(sp, leaves, arrays, True,  # noqa
                                       hists, dloss, None, seed)
    ev = lambda: fg.gob_scan_fwd_cuda(spec_e, leaves, arrays, *st,  # noqa
                                      False, want_hists=False)
    k6 = cuda_ms(bwd, 2, 1)
    stages = stage_device_ms(bwd, 2, -(-K // sp.bwd_chunk(K, B)), k6)
    sp_plain = _staged_plain_ms(sp, leaves, arrays, hists, seed)
    (f5, b5), (f6, b6) = gob_bounds(sp, K, B)
    (fe, be), _ = gob_bounds(sp, K, B, train=False)
    sb = gob_stage_bounds(sp, K, B)
    t = {"K5": (cuda_ms(fwd, 3, 1), plain["K5c"]),
         "K5e": (cuda_ms(ev, 3, 1), plain_e),
         "K6": (k6, plain["K6c"]),
         "K6remat": (stages["remat"], sp_plain["remat"]),
         "K6chain": (stages["chain"], sp_plain["chain"])}
    bd = {"K5": bound(f5, b5, PEAK_FP32), "K5e": bound(fe, be, PEAK_FP32),
          "K6": bound(f6, b6, PEAK_FP32),
          "K6remat": bound(*sb["remat"], PEAK_FP32),
          "K6chain": bound(*sb["chain"], PEAK_FP32)}
    for k, (ms, pms) in t.items():
        bms, by = bd[k]
        say("scope", arm="p4000", kernel=k, ms=f"{ms:.4f}",
            plain_ms=f"{pms:.4f}", bound_ms=f"{bms:.6f}", bound_by=by,
            roofline_share=f"{bms / ms:.2e}")
    out["times"]["gob"], out["bounds"]["gob"] = t, bd
    # the hook: the device-memory form forced at hidden 50, bit for bit
    cfg50, _, _, arrays50, leaves50, st50 = gob_setup(B, K, 50, True, 1e-4,
                                                      50, dev)
    got = []
    for acts in ("shared", "global", "global"):
        s5 = fg.Spec(cfg50, "prng", rows=1, acts=acts)
        s5e = fg.Spec(cfg50, "input", rows=1, acts=acts)
        got.append(_gob_outputs(s5, s5e, leaves50, arrays50, st50, seed))
    torch.cuda.synchronize()
    n_diff = sum(not (torch.equal(a, b) and torch.equal(b, c))
                 for a, b, c in zip(*got))
    if n_diff:
        raise AssertionError(f"scope: the device-memory form differs from "
                             f"the shared form at hidden 50 ({n_diff} "
                             "outputs)")
    say("scope", arm="gob_h50_forms", forms_bit_equal=True,
        outputs=len(got[0]))


def phase_scope(results):
    """The kernels' full scope: E3b (MLPs of 9 to 101 linears), E3a (an
    unmasked output of another width than the input) and E3c (GOB in the
    device-memory form at p_hidden 4,000); each through the entry points a
    user calls with exact launch counts, its kernels against their plain
    versions and timed."""
    import torch

    from njode_tpu_torch.data import datasets

    gen = torch.Generator(device="cuda").manual_seed(16)
    zero = {"K1m": 0.0, "K2m": 0.0, "K3m": 0.0}
    out = {"launches": {"out": []}, "times": {}, "bounds": {},
           "errs": {"out": dict(zero)}}
    tmp = tempfile.mkdtemp(prefix="njode_smoke_scope_")
    try:
        hp = dict(datasets.hyperparam_default, nb_paths=SCOPE_PATHS,
                  obs_perc=0.1)
        datasets.create_dataset("BlackScholes", hp, seed=0,
                                base_path=os.path.join(tmp, "data"))
        for part in (_scope_deep, _scope_gob):
            t0 = time.time()
            part(results, tmp, gen, out)
            say("scope", part=part.__name__[7:],
                part_s=f"{time.time() - t0:.2f}")
        t0 = time.time()
        _scope_out(results, gen, out)
        say("scope", part="out", part_s=f"{time.time() - t0:.2f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["scope"] = out


def trace_gaps(events):
    """Where a Chrome trace of the trainer lacks K2: the steps (by the
    backward's ``FusedNJODELossBackward`` op, in order) whose K2 launch
    has no kernel event, the runtime launches without a kernel event, and
    the first kernel's and the first runtime launch's offset from the
    first CPU op (ms)."""
    kern = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and "Launch" in e.get("name", "")]
    with_kernel = {e.get("args", {}).get("correlation") for e in kern}
    k2_launch = sorted(r["ts"] for r in runtime
                       if r.get("args", {}).get("correlation") in
                       {e["args"].get("correlation") for e in kern
                        if "njode_scan_bwd_kernel" in e["name"]})
    bwd = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and "evaluate_function: FusedNJODELossBackward"
                  in e.get("name", "")), key=lambda e: e["ts"])
    t0 = min(e["ts"] for e in events if e.get("cat") == "cpu_op")
    return dict(
        backward_ops=len(bwd),
        steps_without_k2=[i for i, op in enumerate(bwd)
                          if not any(op["ts"] <= t <= op["ts"] + op["dur"]
                                     for t in k2_launch)][:10],
        launches_without_kernel=sum(
            r.get("args", {}).get("correlation") not in with_kernel
            for r in runtime),
        first_kernel_ms=f"{(min(e['ts'] for e in kern) - t0) / 1e3:.3f}",
        first_launch_ms=f"{(min(r['ts'] for r in runtime) - t0) / 1e3:.3f}")


def phase_profiling(results):
    """The trainer's 'profile_dir' and 'anomaly_detection' on the main path
    (20,000 BlackScholes paths, one epoch of B = 100, 'prng'): the traced
    run's Chrome trace must hold as many K1 and K2 events as the counters
    saw launches (the kernel counts printed; on a mismatch, where the trace
    lacks them, :func:`trace_gaps`),
    the anomaly-detection run must train with exact launch
    counts and leave anomaly mode off; then a step of the kernels with a
    NaN weight under anomaly detection must raise."""
    import glob

    import numpy as np
    import torch

    from njode_tpu_torch.data import datasets
    from njode_tpu_torch.experiments import width_scaling as ws
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import trainer
    from njode_tpu_torch.training.steps import make_optimizer, make_step_fns
    from njode_tpu_torch.utils import profiling
    from njode_tpu_torch.utils.csv_frame import read_frame

    tmp = tempfile.mkdtemp(prefix="njode_smoke_prof_")
    counts, stages = [], []
    try:
        hp = dict(datasets.hyperparam_default, nb_paths=20_000, obs_perc=0.1)
        datasets.create_dataset("BlackScholes", hp, seed=0,
                                base_path=os.path.join(tmp, "data"))
        steps = 16_000 // 100
        expect = {"njode_scan_fwd": steps, "njode_scan_bwd": steps,
                  "njode_scan_eval": 1, "philox_keep": 2 * steps,
                  "reduce_partials": 2 * steps + 1}
        prof = os.path.join(tmp, "trace")
        for tag, kw in (("traced", dict(profile_dir=prof)),
                        ("anomaly", dict(anomaly_detection=True))):
            fs.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.train(epochs=1, batch_size=100, dropout_rate=0.1,
                          dataset="BlackScholes", plot=False,
                          pallas_mask_mode="prng",
                          base_data_path=os.path.join(tmp, "data"),
                          saved_models_path=os.path.join(tmp, tag), **kw)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            c = dict(fs.LAUNCHES)
            _check_counts("profiling", c, expect)
            check_rows("profiling", results["setup"]["cfg"])
            counts.append(c)
            stages.append(_check_stage_counts("profiling", steps))
            cols, rows = read_frame(os.path.join(tmp, tag, "id-1",
                                                 "metric_id-1.csv"))
            say("profiling", run=tag, run_s=f"{run_s:.2f}",
                train_time=dict(zip(cols, rows[0]))["train_time"],
                anomaly_mode_after=torch.is_anomaly_enabled())
        if torch.is_anomaly_enabled():
            raise AssertionError("profiling: anomaly mode left on")
        files = glob.glob(os.path.join(prof, "trace_*.json"))
        if len(files) != 1:
            raise AssertionError(f"profiling: {len(files)} trace files")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kern = {}
        for e in events:
            if e.get("cat") == "kernel":
                base = e["name"].removeprefix("void ").split("<")[0] \
                    .split("(")[0]
                kern[base] = kern.get(base, 0) + 1
        say("profiling", trace_mb=f"{os.path.getsize(files[0]) / 1e6:.1f}",
            kernels=json.dumps(kern).replace(" ", ""))
        # one K1 a step of the traced epoch and K2's stages, a launch a
        # chunk each, as counted
        for name, n in (("njode_scan_fwd_kernel", counts[0]["njode_scan_fwd"]),
                        ("njode_remat_kernel", stages[0]["njode_bwd_remat"]),
                        ("njode_scan_bwd_kernel", stages[0]["njode_bwd_chain"]),
                        ("njode_wgrad_kernel", stages[0]["njode_bwd_wgrad"])):
            if kern.get(name, 0) != n:
                say("profiling", **trace_gaps(events))
                raise AssertionError(f"profiling: the trace holds "
                                     f"{kern.get(name, 0)} {name} events, "
                                     f"the counter {n}")
        # a NaN weight under anomaly detection: the step must raise
        dev = torch.device("cuda")
        cfg = ws._cfg(50, 10)
        model = njode.NJODE(cfg).to(dev)
        K = ws.K_STEPS
        fns = make_step_fns(
            model, make_optimizer(model.parameters(), 1e-3),
            torch.as_tensor((np.arange(1, K + 1) * ws.DT)
                            .astype(np.float32), device=dev),
            torch.full((K,), ws.DT, dtype=torch.float32, device=dev),
            use_kernels=True)
        p, o = (torch.as_tensor(a, device=dev) for a in ws._sim_paths(100))
        idx = torch.arange(100, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        with torch.no_grad():
            model.ode_f.f[0].weight[0, 0] = float("nan")
        fs.reset_launch_counts()
        raised = None
        with profiling.anomaly_detection():
            try:
                fns["train_step"](p, o, idx, 0.5, gen)
            except (RuntimeError, FloatingPointError) as e:
                raised = e
        torch.cuda.synchronize()
        if raised is None or fs.LAUNCHES["njode_scan_fwd"] != 1:
            raise AssertionError("profiling: a NaN step through the kernels "
                                 "did not raise under anomaly detection")
        say("profiling", nan_step=type(raised).__name__,
            message=f"'{str(raised).splitlines()[0][:90]}'")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["profiling"] = dict(launches=counts)


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
    # the width study's epochs (both plans) and the profiling phase's runs
    wl = results["width"]["launches"] + results["profiling"]["launches"]
    we = results["width"]["errs"]
    # the tp phase: entry()'s launches and the dry run's rank 0's (its
    # masked K1/K2 count under the masked rows)
    tp = results["tp"]
    for name, key, replaces, count in rows:
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        # the main path: the per-epoch and chunked trainer runs, the bench
        launches = sum(results[r][count] for r in (
            "launches", "chunk_launches", "bench_launches"))
        launches += tp["entry"].get(count, 0)
        if count in ("njode_scan_eval", "philox_keep", "reduce_partials"):
            launches += tp["dryrun"].get(count, 0)
        if name == "reduce_partials":    # runs on every path
            launches += sum(c["reduce_partials"]
                            for c in (gl, cn, cg, pl, p2, rl, cr, pr, sn, sm))
        elif name == "philox_keep":      # the NJODE paths
            launches += sum(c["philox_keep"]
                            for c in (cn, pl, p2, rl, cr, pr, sn, sm))
        else:
            launches += sn[count]
        launches += sum(c[count] for c in wl)
        err = results["errs"][key]
        if key in ("K1", "K2", "K3"):
            err = max(err, se["resident"][key + "m"],
                      we["resident"][key + "m"])
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": results["library_ms"].get(key),
                    **(results["k1_walk"] if key == "K1" else {})})
    # K2's stages at the main path (B = 200; device ms a call), launches
    # from the main path's runs (trainer, chunk, bench: one a chunk each)
    ks = results["k2_stages"]
    runs = [results[r] for r in ("stage_launches", "chunk_stage_launches",
                                 "bench_stage_launches")]
    for name, key, replaces in (
            ("njode_bwd_remat", "remat", "njode_tpu/ops/fused_scan.py:1164"),
            ("njode_bwd_chain", "chain", "njode_tpu/ops/fused_scan.py:1164"),
            ("njode_bwd_wgrad", "wgrad", "njode_tpu/ops/fused_scan.py:522")):
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": sum(c[name] for c in runs),
                    "max_abs_err": ks["errs"][key], "ms": ks["ms"][key],
                    "plain_ms": ks["plain"][key],
                    "bound_ms": ks["bounds"][key][0],
                    "bound_by": ks["bounds"][key][1],
                    "library_ms": ks["library_ms"] if key == "wgrad"
                    else None})
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
             + sm["njode_scan_fwd"] + tp["dryrun"]["njode_scan_fwd"]),
            ("njode_scan_bwd_masked", "K2m", src,
             "njode_tpu/ops/fused_scan.py:772",
             cn["njode_scan_bwd"] + pl["njode_scan_bwd"]
             + sm["njode_scan_bwd"] + tp["dryrun"]["njode_scan_bwd"]),
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
                    "launches": p2[name] + sn[name]
                    + sum(c[name] for c in wl),
                    "max_abs_err": max(pe[key + "m"],
                                       se["global"][key + "m"],
                                       we["global"][key + "m"]),
                    "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the GRU jump (use_rnn) of K1-K3, timed at the main path; launches
    # from its trainer phase, the climate one and the PhysioNet one (the
    # resident plan), errors the largest of its checks at the main path,
    # the climate small arm and phys50 (resident, and global / 16)
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
                    "launches": rl[name] + cr[name] + pr[name],
                    "max_abs_err": err[key], "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    # K1/K2 over a member axis and the member reduce_partials (the groups
    # phase): timed at the main path at E = 5 (B = 100), launches from its
    # group trainers (both plans), errors the largest of its E = 3 checks
    g = results["groups"]
    gm = g["times"]["main"]
    member_launches = {}
    par = results["parallel"]
    # the groups phase's runs and the parallel phase's group on two ranks
    for counts in list(g["launches"].values()) + par["launches"]["group"]:
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
                    "bound_by": gm[key]["bound_by"], "library_ms": None,
                    **({k: gm["K1"][k] for k in
                        ("threads", "walk", "phases_per_step")}
                       if key == "K1" else {})})
    r = g["reduce"]
    out.append({"name": "reduce_partials_members", "route": "cuda",
                "source": src, "replaces": "njode_tpu/ops/fused_scan.py:522",
                "launches": member_launches["reduce_partials_members"],
                "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
    # data parallelism (the parallel phase): K1/K2 and K5/K6 at one rank's
    # rows, timed alone on the card; launches: every launch made under a
    # mesh (NCCL at world size 1, both gloo ranks); errors: one step at two
    # ranks against the kernel without a mesh
    pl = par["launches"]
    ranks = pl["main"] + pl["climate"]
    for name, key, s, replaces, launches, err in (
            ("njode_scan_fwd_dp", "K1", src,
             "njode_tpu/ops/fused_scan.py:1482",
             pl["nccl1"]["njode_scan_fwd"]
             + sum(c["njode_scan_fwd"] for c in ranks), par["errs"]["njode"]),
            ("njode_scan_bwd_dp", "K2", src,
             "njode_tpu/ops/fused_scan.py:1482",
             pl["nccl1"]["njode_scan_bwd"]
             + sum(c["njode_scan_bwd"] for c in ranks), par["errs"]["njode"]),
            ("gob_scan_fwd_dp", "K5", gsrc,
             "njode_tpu/ops/fused_gob.py:1100",
             sum(c["gob_scan_fwd"] for c in pl["gob"]), par["errs"]["gob"]),
            ("gob_scan_bwd_dp", "K6", gsrc,
             "njode_tpu/ops/fused_gob.py:1100",
             sum(c["gob_scan_bwd"] for c in pl["gob"]), par["errs"]["gob"])):
        ms, plain = par["times"][key]
        bms, by = par["bounds"][key]
        out.append({"name": name, "route": "cuda", "source": s,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the full scope (the scope phase): K1-K3 with an unmasked output of
    # another width than the input (E3a: the fused loss and eval functions'
    # launches, the global plan at 16 rows and at one, both jumps; timed at
    # HestonWOFeller return_vol, D = 2, O = 1) and with an ODE net of 9 to
    # 101 linears (E3b: each arm's own row, its trainer epoch's launches,
    # or at 101 linears the fused loss and eval functions'), and K5, its
    # eval form and K6 in the device-memory form (E3c: p_hidden 4,000, the
    # trainer's launches; K6 whole and its stages (a) and (b))
    sc = results["scope"]
    parts = [("out", sc["launches"]["out"])] + [
        (f"deep{n}", [sc["launches"][f"deep{n}"]]) for n, _, _ in SCOPE_DEEP]
    for part, counts in parts:
        for base, key, replaces in zip(
                ("njode_scan_fwd", "njode_scan_bwd", "njode_scan_eval"),
                ("K1", "K2", "K3"), ("njode_tpu/ops/fused_scan.py:1145",
                                     "njode_tpu/ops/fused_scan.py:1195",
                                     "njode_tpu/ops/fused_scan.py:1318")):
            ms, plain = sc["times"][part][key]
            bms, by = sc["bounds"][part][key]
            out.append({"name": f"{base}_{part}", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": sum(v for c in counts
                                        for k, v in c.items()
                                        if k.startswith(base)
                                        and "members" not in k),
                        "max_abs_err": sc["errs"][part][key + "m"],
                        "ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by, "library_ms": None})
    gc = sc["launches"]["gob"]
    for name, key, replaces, launches, err in (
            ("gob_scan_fwd_ga", "K5", "njode_tpu/ops/fused_gob.py:942",
             gc["gob_scan_fwd"], sc["errs"]["gob"]["K5"]),
            ("gob_scan_eval_ga", "K5e", "njode_tpu/ops/fused_gob.py:942",
             gc["gob_scan_eval"], sc["errs"]["gob"]["K5e"]),
            ("gob_scan_bwd_ga", "K6", "njode_tpu/ops/fused_gob.py:991",
             gc["gob_scan_bwd"], sc["errs"]["gob"]["K6"]),
            ("gob_bwd_remat_ga", "K6remat", "njode_tpu/ops/fused_gob.py:991",
             gc["gob_bwd_remat"], sc["errs"]["gob"]["K6"]),
            ("gob_bwd_chain_ga", "K6chain", "njode_tpu/ops/fused_gob.py:991",
             gc["gob_scan_bwd"], sc["errs"]["gob"]["K6"])):
        ms, plain = sc["times"]["gob"][key]
        bms, by = sc["bounds"]["gob"][key]
        out.append({"name": name, "route": "cuda", "source": gsrc,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None})
    return json.dumps({"kernels": out})


def main():
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--seq-cpu"]:       # start_seq_cpu's child
        seq_cpu_job(*sys.argv[2:4])
        return 0
    if not os.path.isdir(os.path.join(ROOT, "njode_tpu_torch")):
        print("chip_smoke: the njode_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    import threading

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
    libs = ("fused_scan", "fused_gob")
    build = {}

    def build_libs():                  # one nvcc per source, in parallel
        try:
            _build.build_all(libs)
        except BaseException as e:     # raised again by the main thread
            build["error"] = e

    results = {}
    # the climate stand-in stays on disk for the sweep's climate run
    tmp = tempfile.mkdtemp(prefix="njode_smoke_climate_")
    t_build = time.time()
    nvcc_thread = threading.Thread(target=build_libs)
    nvcc_thread.start()
    try:
        # the set-ups and the phases that launch none of the kernels run
        # while nvcc builds them
        climate_setup(results, tmp)
        physionet_setup(results)
        start_seq_cpu(results, tmp)
        t0 = time.time()
        for phase in (phase_seq_gob, phase_mixed_precision,
                      phase_tp_eager):
            phase(results)
            say(phase.__name__[6:], phase_s=f"{time.time() - t0:.2f}",
                while_building=nvcc_thread.is_alive())
            t0 = time.time()
        nvcc_thread.join()
        if "error" in build:
            raise build["error"]
        from njode_tpu_torch.ops import fused_scan as fs
        for name in libs:
            _build.load(name)
            log = _build.build_log[name]
            say("build", lib=name, nvcc_s=f"{log['seconds']:.2f}",
                **({"param_bytes": fs.param_bytes()}
                   if name == "fused_scan" else {}))
            for ln in log["ptxas"].splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    print("[build] " + ln.strip(), flush=True)
        say("build", seconds=f"{time.time() - t_build:.2f}")
        t0 = time.time()
        for phase in (phase_native, phase_kernels, phase_timing,
                      phase_k2_stages, phase_trainer,
                      phase_rnn_kernels, phase_rnn_timing,
                      phase_gob_kernels, phase_gob_timing,
                      phase_gob_trainer, phase_sync, phase_busy, phase_bench,
                      phase_climate_kernels, phase_climate_timing,
                      phase_climate_trainer, phase_climate_rnn,
                      phase_physionet_kernels, phase_physionet_timing,
                      phase_physionet_trainer, phase_physionet_rnn,
                      phase_sweep, phase_groups, phase_parallel, phase_tp,
                      phase_width_scaling, phase_scope,
                      phase_profiling):
            phase(results)
            say(phase.__name__[6:], phase_s=f"{time.time() - t0:.2f}")
            t0 = time.time()
    finally:
        if "seq_cpu" in results:            # a phase before seq_gob failed
            results["seq_cpu"]["proc"].kill()
            results["seq_cpu"]["proc"].wait()
        nvcc_thread.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print(kernels_line(results), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
