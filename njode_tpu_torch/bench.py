"""Benchmark: NJODE training throughput (paths/sec/chip) of the port on one
CUDA card, at the demo-parity configuration of the repo's ``bench.py``,
against the reference's ~200 paths/sec CPU baseline (BASELINE.md).

    python -m njode_tpu_torch.bench [--device cuda]

Prints the card's name and power limit (``nvidia-smi``), then ONE JSON line
with ``bench.py``'s keys. The headline rate is the chunked one: epochs run
through ``train_epochs`` (several epochs and their evaluations queued
before the host reads a result). Beside it, epochs run one call at a time
and each synchronised, and the same epochs queued back to back with one
synchronise. Every time is the host clock around work that ends in
``torch.cuda.synchronize()``. Without a CUDA card the bench raises: it does
not carry on on the CPU (``main(device="cpu")`` runs it there for tests,
at small sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

BASELINE_PATHS_PER_SEC = 200.0  # the reference on a CPU: ~78-84 s/epoch
# for 16k paths (BASELINE.md)

# The H100 SXM data sheet's float32 peak outside the tensor cores (the
# published figure at 700 W, not a measurement): the kernels are fp32 FMA
# chains and TF32 stays off, so this is the peak their arithmetic can reach.
PEAK_TFLOPS = 67.0


def bench_config():
    """The demo-parity model (BASELINE.md): hidden 10, three 2x50 tanh
    nets, dropout 0.1."""
    from njode_tpu_torch.models import njode

    nn_desc = ((50, "tanh"), (50, "tanh"))
    return njode.NJODEConfig(input_size=1, hidden_size=10, output_size=1,
                             ode_nn=nn_desc, readout_nn=nn_desc,
                             enc_nn=nn_desc, dropout_rate=0.1)


def train_flops_per_path(cfg, n_steps):
    """Matmul FLOPs one path costs per TRAINING step, from the config's
    net widths: per grid step the scan applies ode_f once, the encoder once
    (jump candidate) and the readout twice (pre- and post-jump); the
    backward is counted as twice the forward, so 3x in all."""
    from njode_tpu_torch.models import njode

    fwd = 0
    for which, mult in (("ode_f", 1), ("encoder", 1), ("readout", 2)):
        ws = njode.net_widths(cfg, which)
        fwd += mult * sum(2 * a * b for a, b in zip(ws[:-1], ws[1:]))
    return 3 * n_steps * fwd


def simulate_bs_paths(n_paths, n_steps, dt, drift=2.0, vol=0.3, seed=0):
    """Black-Scholes Euler paths on the host (numpy), ``[N, 1, T+1]``
    float32: the same draws as ``bench.py``'s."""
    rs = np.random.RandomState(seed)
    x = np.ones((n_paths, 1), dtype=np.float64)
    out = [x]
    for _ in range(n_steps):
        dW = rs.normal(0.0, 1.0, x.shape) * np.sqrt(dt)
        x = x + drift * x * dt + vol * x * dW
        out.append(x)
    return np.stack(out, axis=-1).astype(np.float32)


def card_line():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(n_paths=16_000, batch_size=200, n_steps=100, device="cuda",
         reps=None, chunk=7):
    """Run the bench and print its lines; returns the JSON object.

    :param reps: epochs timed each way (default ``NJODE_BENCH_REPS``, 7)
    :param chunk: epochs a ``train_epochs`` call
    """
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.training.steps import make_optimizer, make_step_fns

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    N, B, K = n_paths, batch_size, n_steps
    dt = 1.0 / K
    paths = simulate_bs_paths(N, K, dt)
    rs = np.random.RandomState(1)
    obs = (rs.random((N, K + 1)) < 0.1).astype(np.float32)

    cfg = bench_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = njode.NJODE(cfg).to(device)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    # the fused kernels on the card (their plain versions on the CPU)
    fns = make_step_fns(
        model, optimizer,
        torch.as_tensor((np.arange(1, K + 1) * dt).astype(np.float32),
                        device=device),
        torch.full((K,), dt, dtype=torch.float32, device=device),
        use_kernels=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    d_paths = torch.as_tensor(paths, device=device)
    d_obs = torch.as_tensor(obs, device=device)
    perm = np.random.RandomState(3).permutation(N)
    idx_mat = torch.as_tensor(perm.reshape(N // B, B), device=device)

    def epoch(seed):
        return fns["train_epoch"](d_paths, d_obs, idx_mat, 0.5, gen(seed))

    # warm-up: one epoch (N / B steps)
    epoch(0)
    sync()

    # N_REP epochs, each synchronised: one host round trip an epoch
    n_rep = int(reps or os.environ.get("NJODE_BENCH_REPS", "7"))
    times = []
    for r in range(n_rep):
        t0 = time.perf_counter()
        epoch(1 + r)
        sync()
        times.append(time.perf_counter() - t0)
    elapsed = sorted(times)[n_rep // 2]

    # the same epochs queued back to back, one synchronise for all
    t0 = time.perf_counter()
    for r in range(n_rep):
        epoch(100 + r)
    sync()
    pipelined = (time.perf_counter() - t0) / n_rep

    # train_epochs in chunks of CH epochs, each with the validation loss on
    # 8 paths (no oracle difference): one warm-up chunk, three timed
    CH = chunk
    val_idx = torch.arange(8, device=device)

    def chunk_args(r):
        mats = torch.as_tensor(np.stack([
            np.random.RandomState(50 + r * CH + j).permutation(N).reshape(
                N // B, B) for j in range(CH)]), device=device)
        return (mats, [0.5] * CH,
                [gen(200 + r * CH + j) for j in range(CH)])

    def run_chunk(args):
        fns["train_epochs"](d_paths, d_obs, *args, d_paths, d_obs, val_idx,
                            False)
        sync()

    run_chunk(chunk_args(0))
    creps = []
    for r in range(1, 4):
        args = chunk_args(r)
        t0 = time.perf_counter()
        run_chunk(args)
        creps.append((time.perf_counter() - t0) / CH)
    chunked = sorted(creps)[1]

    paths_per_sec = N / chunked
    flops_path = train_flops_per_path(cfg, K)
    tflops = paths_per_sec * flops_path / 1e12
    out = {
        "metric": "train_throughput_paths_per_sec_per_chip",
        "value": round(paths_per_sec, 1),
        "unit": "paths/sec/chip",
        "vs_baseline": round(paths_per_sec / BASELINE_PATHS_PER_SEC, 2),
        "flops_per_path": flops_path,
        "device_tflops": round(tflops, 3),
        "mfu_pct": round(100.0 * tflops / PEAK_TFLOPS, 3),
        "epoch_chunk": CH,
        "per_epoch_dispatch": {
            "paths_per_sec": round(N / elapsed, 1),
            "spread": {"n": n_rep,
                       "min": round(N / max(times), 1),
                       "max": round(N / min(times), 1)},
            "epoch_s": [round(t, 4) for t in times]},
        "pipelined_paths_per_sec": round(N / pipelined, 1),
    }
    print(card_line() if device.type == "cuda"
          else f"device: {device} (not a card)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="NJODE training throughput of the PyTorch/CUDA port")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    main(device=parser.parse_args().device)
