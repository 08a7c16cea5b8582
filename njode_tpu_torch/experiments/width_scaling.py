"""Width-scaling study: NJODE training throughput against network width on
one CUDA card, the port's copy of ``njode_tpu/experiments/width_scaling.py``.

:func:`card_side` trains the study's model (D = 1, hidden 50, three 2 x
width tanh MLPs, dropout 0.1) at widths 50-400 on 16,000 Black-Scholes
paths (K = 100, batch 200) through the port's ``make_step_fns``, with the
fused kernels K1/K2 where ``fused_scan.supported`` admits the config:
a first epoch, then ``n_rep`` epochs each ending in
``torch.cuda.synchronize()`` (median, min, max) and ``n_rep`` epochs
queued back to back with one synchronise. Each row also names the plan and
rows the kernels take and the launches the run made.

:func:`ref_side` timed the reference implementation's own torch NJODE on
the CPU; that code is not in this repository, so it raises until it is.

    python -m njode_tpu_torch.experiments.width_scaling [--out PATH]

Writes ``results/width_scaling_torch.json`` (or ``--out``) and prints the
card's name and power limit, a line per width and a markdown table.
Without a CUDA card it raises (``card_side(device="cpu")`` runs it on the
CPU for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

K_STEPS = 100
OBS_PERC = 0.1
DT = 1.0 / K_STEPS


def _sim_paths(n_paths, seed=0):
    """Black-Scholes Euler paths ``[N, 1, K+1]`` float32 and their
    observation mask ``[N, K+1]`` (the JAX study's draws, bit for bit)."""
    rs = np.random.RandomState(seed)
    x = np.ones((n_paths, 1), dtype=np.float64)
    out = [x]
    for _ in range(K_STEPS):
        dW = rs.normal(0.0, 1.0, x.shape) * np.sqrt(DT)
        x = x + 2.0 * x * DT + 0.3 * x * dW
        out.append(x)
    paths = np.stack(out, axis=-1).astype(np.float32)    # [N, 1, K+1]
    obs = (np.random.RandomState(seed + 1).random(
        (n_paths, K_STEPS + 1)) < OBS_PERC).astype(np.float32)
    return paths, obs


def _cfg(width, hidden):
    from njode_tpu_torch.models import njode
    nn_desc = ((width, "tanh"), (width, "tanh"))
    return njode.NJODEConfig(
        input_size=1, hidden_size=hidden, output_size=1,
        ode_nn=nn_desc, readout_nn=nn_desc, enc_nn=nn_desc,
        dropout_rate=0.1)


def kernel_plan(cfg, batch_size):
    """``(plan, K1 rows, K2 rows)`` the kernels take at ``batch_size``, or
    None where ``fused_scan.supported`` refuses the config."""
    from njode_tpu_torch.ops import fused_scan

    if not fused_scan.supported(cfg):
        return None
    spec = fused_scan.Spec(cfg)
    return (spec.plan, spec.rows_for(batch_size, False),
            spec.rows_for(batch_size, True))


def card_side(widths=(50, 100, 200, 400), hidden=50, n_paths=16_000,
              batch_size=200, n_rep=5, device="cuda", log=print):
    """Epoch throughput per width; returns the rows (``log`` takes each
    printed line)."""
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.ops import fused_scan
    from njode_tpu_torch.training.steps import make_optimizer, make_step_fns

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the study needs a CUDA card "
                           "(torch.cuda.is_available() is False)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    paths, obs = _sim_paths(n_paths)
    d_paths = torch.as_tensor(paths, device=device)
    d_obs = torch.as_tensor(obs, device=device)
    times = torch.as_tensor((np.arange(1, K_STEPS + 1) * DT)
                            .astype(np.float32), device=device)
    dts = torch.full((K_STEPS,), DT, dtype=torch.float32, device=device)
    idx_mat = torch.as_tensor(np.random.RandomState(3).permutation(
        n_paths).astype(np.int64).reshape(n_paths // batch_size,
                                          batch_size), device=device)
    rows = []
    for width in widths:
        cfg = _cfg(width, hidden)
        plan = kernel_plan(cfg, batch_size)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = njode.NJODE(cfg).to(device)
        optimizer = make_optimizer(model.parameters(), 1e-3)
        fns = make_step_fns(model, optimizer, times, dts,
                            use_kernels=plan is not None)
        gen = torch.Generator(device=device).manual_seed(2)
        before = dict(fused_scan.LAUNCHES)

        def epoch():
            return fns["train_epoch"](d_paths, d_obs, idx_mat, 0.5, gen)

        t0 = time.perf_counter()
        losses = epoch()
        sync()
        first_s = time.perf_counter() - t0
        reps = []
        for _ in range(n_rep):
            t0 = time.perf_counter()
            losses = epoch()
            sync()
            reps.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(n_rep):
            losses = epoch()
        sync()
        queued = (time.perf_counter() - t0) / n_rep
        med = sorted(reps)[n_rep // 2]
        launches = {k: v - before[k] for k, v in fused_scan.LAUNCHES.items()
                    if v != before[k]}
        rows.append({
            "width": width, "hidden": hidden, "batch_size": batch_size,
            "kernel": plan is not None,
            "plan": None if plan is None else plan[0],
            "rows_fwd": None if plan is None else plan[1],
            "rows_bwd": None if plan is None else plan[2],
            "device": str(device), "paths_per_sec": n_paths / med,
            "pipelined_paths_per_sec": n_paths / queued,
            "epoch_s_median": med, "epoch_s_min": min(reps),
            "epoch_s_max": max(reps), "first_epoch_s": first_s,
            "last_loss": float(losses[-1]), "launches": launches})
        log("card " + json.dumps(rows[-1]))
    return rows


def ref_side(*args, **kwargs):
    """The reference implementation's torch NJODE on the CPU, on the same
    event-encoded batch (its ``NJODE/models.py``): that code is not in
    this repository and not on the card machine, so this raises until it
    is added."""
    raise NotImplementedError(
        "width_scaling.ref_side times the reference implementation's own "
        "torch NJODE (NJODE/models.py of the reference code), which is not "
        "in this repository (ROADMAP.md, 'Not ported, by design')")


def table(rows):
    """The markdown table of :func:`card_side`'s rows."""
    lines = ["| width | hidden | plan / rows (K1, K2) | paths/s | "
             "queued paths/s | epoch s (median) |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        plan = (f"{r['plan']} / {r['rows_fwd']}, {r['rows_bwd']}"
                if r["kernel"] else "eager")
        lines.append(f"| {r['width']} | {r['hidden']} | {plan} | "
                     f"{r['paths_per_sec']:.1f} | "
                     f"{r['pipelined_paths_per_sec']:.1f} | "
                     f"{r['epoch_s_median']:.4f} |")
    return "\n".join(lines)


def main(out_path="results/width_scaling_torch.json", run_ref=False,
         device="cuda", **card_kw):
    """Run the card side (and, with ``run_ref``, the reference side, which
    raises), write ``out_path`` and print the table."""
    from njode_tpu_torch.bench import card_line

    card = card_line() if torch.device(device).type == "cuda" else None
    if card:
        print(card, flush=True)
    out = {"config": {"K": K_STEPS, "obs_perc": OBS_PERC,
                      "n_paths": card_kw.get("n_paths", 16_000),
                      "batch_size": card_kw.get("batch_size", 200)},
           "card": card}
    out["rows"] = card_side(device=device, **card_kw)
    if run_ref:
        out["reference"] = ref_side()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(table(out["rows"]), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/width_scaling_torch.json")
    ap.add_argument("--ref", action="store_true",
                    help="also the reference side (raises: not in the "
                         "repository)")
    a = ap.parse_args()
    main(a.out, run_ref=a.ref)
