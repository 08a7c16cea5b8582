"""A/B timing of the NJODE scan kernels (K1-K3, resident plan) of one
checkout on one CUDA card, to compare two versions within one machine.

    python3 ab_scan_kernels.py ROOT TAG

ROOT is a checkout holding ``njode_tpu_torch/`` and ``chip_smoke.py`` (e.g.
the parent commit unpacked with ``git archive`` into a git-ignored
directory); TAG names it in the output. Run the versions alternately in one
call (parent, change, change, parent). Prints the build time, ptxas's
register and spill lines, then one line of CUDA-event ms: the main path's
K1/K2/K3 ('prng', K = 100) at B = 200 and 100, and the masked K1/K2/K3 at
the climate small arm's widths on a synthetic masked batch (B = 100,
K = 2,004, 2 % of the rows observed a step)."""

import sys
import time


def main(root, tag):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from njode_tpu_torch.data.grid import GridBatch
    from njode_tpu_torch.ops import _build
    from njode_tpu_torch.ops import fused_scan as fs

    t0 = time.time()
    _build.build_all(("fused_scan",))
    _build.load("fused_scan")
    print(tag, "build_s", round(time.time() - t0, 2), flush=True)
    for ln in _build.build_log["fused_scan"]["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(tag, ln.strip())
    dev = torch.device("cuda")
    one = torch.ones((), device=dev)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    out = {}

    def time_three(cfg, leaves, arrays, h0, suffix, reps, warmup):
        spec, spec3 = fs.Spec(cfg, "prng"), fs.Spec(cfg, "input")
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

    for B in (200, 100):
        cfg, model, batch = cs.main_path_setup(B, 100, 0, dev)
        arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
                  batch.start_X)
        with torch.no_grad():
            h0 = model.encoder_map(batch.start_X)
        time_three(cfg, [p.detach() for p in fs.flat_leaves(model)], arrays,
                   h0, f" B={B}", 20, 2)
    rs = np.random.RandomState(0)
    K, B, D = 2004, 100, 5
    obs = (rs.random((K, B)) < 0.02).astype(np.float32)
    M = (rs.random((K, B, D)) < 0.4).astype(np.float32) * obs[:, :, None]
    X = rs.normal(size=(K, B, D)).astype(np.float32) * M
    times = (np.arange(1, K + 1) * 0.1).astype(np.float32)
    b = GridBatch(times=torch.as_tensor(times, device=dev),
                  dt=torch.full((K,), 0.1, device=dev),
                  obs=torch.as_tensor(obs, device=dev),
                  X=torch.as_tensor(X, device=dev),
                  M=torch.as_tensor(M, device=dev),
                  start_X=torch.zeros((B, D), device=dev),
                  n_obs_ot=torch.as_tensor(obs.sum(0), device=dev))
    if hasattr(cs, "_masked_njode"):
        cfg, model = cs._masked_njode(5, 10, 50, dev)
    else:                                 # checkouts before the global plan
        cfg, model = cs._climate_njode(dev)
    with torch.no_grad():
        h0 = fs.t0_state(model, b)
    time_three(cfg, [p.detach() for p in fs.flat_leaves(model)],
               fs.batch_arrays(b), h0, "m", 3, 1)
    print(tag, " ".join(f"{k}={v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
