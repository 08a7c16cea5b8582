"""Mixed-precision (``compute_dtype='bfloat16'``) step-time study on one
CUDA card, the port's copy of
``njode_tpu/experiments/mixed_precision_study.py``.

Times the eager train step (forward, backward and an Adam update) in
float32 and with bfloat16 matmul operands (``models/mlp.py``: float32 sums
on the tensor cores) at the bench's shape and at two wide shapes where the
products are large. The batch lives on the card. Each of ``reps`` steps is
timed alone, ending in ``torch.cuda.synchronize()`` (the median is
printed), then ``reps`` steps are queued back to back with one
synchronise (the per-step mean). TF32 stays off.

    python -m njode_tpu_torch.experiments.mixed_precision_study [--out PATH]

Prints the card's name and power limit, one JSON line per shape and dtype
with the JAX study's keys, and a summary line; ``--out`` also writes the
rows as JSON. Without a CUDA card it raises (``run(device="cpu")`` runs it
on the CPU for tests).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SHAPES = [
    # (tag, B, K, D, width, hidden)
    ("bench-shape", 200, 100, 1, 50, 10),
    ("wide-512", 2048, 100, 1, 512, 256),
    ("wide-1024", 4096, 50, 1, 1024, 512),
]


def make_batch(B, K, D, device, seed=0, obs_perc=0.1):
    """A GridBatch of lognormal paths on ``device``, every row observed at
    least once (the JAX study's draws)."""
    from njode_tpu_torch.data import grid

    rs = np.random.RandomState(seed)
    dt = 1.0 / K
    paths = rs.lognormal(0.0, 0.3, size=(B, D, K + 1))
    obs = (rs.random((B, K + 1)) < obs_perc).astype(np.int64)
    obs[:, 0] = 0
    for i in range(B):
        if obs[i].sum() == 0:
            obs[i, 1 + rs.randint(K)] = 1
    b = grid.recompute_n_obs(grid.batch_from_paths(paths, obs, dt))
    return grid.to_torch(b, device)


def model_macs_per_pathstep(model) -> int:
    """Matmul MACs per (path, grid step): every Linear and GRU weight of
    the port's modules once a step, the readout's twice (its pre- and
    post-jump applications ride one stacked product)."""
    from njode_tpu_torch.models import mlp

    apps = {"ode_f": (model.ode_f.f, 1), "encoder": (model.encoder_map.ffnn,
                                                     1),
            "readout": (model.readout_map.ffnn, 2)}
    total = 0
    for seq, mult in apps.values():
        total += mult * sum(lin.weight.numel() for lin in mlp.linears(seq))
    if hasattr(model, "obs_c"):
        total += sum(p.numel() for p in model.obs_c.parameters()
                     if p.dim() == 2)
    return total


def time_step(cfg, batch, device, seed=1, reps=10, warmup=3):
    """``(median step s, queued step s, last loss, MACs per path-step)``
    of the eager train step of a model seeded with ``seed`` (the same
    weights for either dtype) under Adam 1e-3."""
    from njode_tpu_torch.models import njode

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = njode.NJODE(cfg).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step():
        opt.zero_grad(set_to_none=False)
        _, loss = njode.forward(model, batch, train=True, generator=gen)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(warmup):
        loss = step()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        loss = step()
        sync()
        ts.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(reps):
        loss = step()
    sync()
    piped = (time.perf_counter() - t0) / reps
    return (float(np.median(ts)), float(piped), float(loss),
            model_macs_per_pathstep(model))


def run(shapes=SHAPES, reps=10, device="cuda", warmup=3, log=print):
    """Every shape in float32 and bfloat16; returns the rows. ``log``
    takes each printed line."""
    from njode_tpu_torch.models import njode

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the study needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for tag, B, K, D, W, H in shapes:
        batch = make_batch(B, K, D, device)
        row = {"tag": tag, "B": B, "K": K, "D": D, "width": W, "hidden": H}
        for cd in ("float32", "bfloat16"):
            cfg = njode.NJODEConfig(
                input_size=D, hidden_size=H, output_size=D,
                ode_nn=((W, "tanh"),), readout_nn=((W, "tanh"),),
                enc_nn=((W, "tanh"),), dropout_rate=0.1, compute_dtype=cd)
            med, piped, loss, macs = time_step(cfg, batch, device,
                                               reps=reps, warmup=warmup)
            # forward 2 * MACs, backward twice the forward
            tflops = 6.0 * macs * B * K / piped / 1e12
            row[cd] = {"step_s": med, "piped_step_s": piped,
                       "paths_per_s": B / piped, "approx_tflops": tflops,
                       "loss": loss}
            log(json.dumps({**{k: row[k] for k in ("tag", "B", "K", "width")},
                            "dtype": cd, **row[cd]}))
        row["speedup"] = (row["float32"]["piped_step_s"]
                          / row["bfloat16"]["piped_step_s"])
        rows.append(row)
    log(json.dumps({"summary": [{r["tag"]: r["speedup"]} for r in rows]}))
    return rows


def main(argv=None):
    from njode_tpu_torch.bench import card_line
    from njode_tpu_torch.models import mlp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the study needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    print(card_line(), flush=True)
    rows = run(reps=args.reps)
    print(json.dumps({"bf16_routes": mlp.BF16_ROUTES}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "rows": rows,
                       "bf16_routes": mlp.BF16_ROUTES}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
