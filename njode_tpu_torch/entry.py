"""Entry points of the port, the counterparts of the repo's
``__graft_entry__.py``: the flagship's training loss as ``(fn, args)`` and
the multi-rank dry run.

    python -m njode_tpu_torch.entry              # the flagship loss, one card
    python -m njode_tpu_torch.entry dryrun [N]   # N ranks (default 2)

Both run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

DRYRUN_TIMEOUT = 600      # seconds the dry run's ranks may take


def _device(device):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this entry point needs a CUDA card "
                           "(torch.cuda.is_available() is False); pass "
                           "device='cpu' to run it on the CPU")
    return dev


def _seeded_model(cfg, seed, dev):
    from njode_tpu_torch.models import njode

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return njode.NJODE(cfg).to(dev)


def _flagship_arrays():
    """The flagship's data as numpy arrays, the draws of
    ``__graft_entry__._flagship``: ``(paths [200, 1, 101], obs [200, 101],
    times [100], dts [100])``, float32."""
    B, K = 200, 100
    dt = 1.0 / K
    rs = np.random.RandomState(0)
    paths = np.exp(rs.normal(0, 0.1, (B, 1, K + 1)).cumsum(-1)).astype(
        np.float32)
    obs = (rs.random((B, K + 1)) < 0.1).astype(np.float32)
    times = (np.arange(1, K + 1) * dt).astype(np.float32)
    dts = np.full(K, dt, dtype=np.float32)
    return paths, obs, times, dts


def flagship(device=None):
    """The demo-parity flagship (BASELINE.md): BlackScholes 1-D, hidden 10,
    three 2x50 tanh nets, dropout 0.1, batch 200, 100 grid steps: ``(cfg,
    model, batch)``, the model initialised under ``torch.manual_seed(0)``."""
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.training.steps import dense_batch

    dev = _device(device)
    nn_desc = ((50, "tanh"), (50, "tanh"))
    cfg = njode.NJODEConfig(input_size=1, hidden_size=10, output_size=1,
                            ode_nn=nn_desc, readout_nn=nn_desc,
                            enc_nn=nn_desc, dropout_rate=0.1)
    batch = dense_batch(*(torch.as_tensor(a, device=dev)
                          for a in _flagship_arrays()))
    return cfg, _seeded_model(cfg, 0, dev), batch


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is the flagship's training loss
    through the fused loss (on the card K1 with 'prng' masks, on the CPU
    its plain version); ``fn(*args, train=False)`` the same without
    dropout. The first call on the card builds the kernels."""
    from njode_tpu_torch.ops import fused_scan

    dev = _device(device)
    cfg, model, batch = flagship(dev)
    fused = fused_scan.make_fused_loss_fn(cfg, mask_mode="prng")

    def fwd(model, batch, generator, train=True):
        return fused(model, batch, 0.5, generator, train)

    return fwd, (model, batch, torch.Generator(device=dev).manual_seed(1))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _check(what, ok, detail):
    if not ok:
        raise AssertionError(f"{what}: {detail}")


def _close_loss(what, got, ref, rel):
    _check(what, abs(got - ref) <= rel * max(1.0, abs(ref)),
           f"{ref} vs {got}")


def _close_params(what, got, ref, tol=(1e-4, 1e-6)):
    d = float((got - ref).abs().max())
    _check(what, torch.allclose(got, ref, rtol=tol[0], atol=tol[1]),
           f"max|d|={d}")
    return d


# the North-star gradient tolerance (rtol, atol): Adam's first step moves
# each parameter by about lr * sign(gradient), so the parameters after it
# cannot show a gradient off by a constant factor; the gradients can
GRAD_TOL = (2e-4, 2e-5)


def _dryrun_rank(mesh, device):
    """Every part of ``__graft_entry__.dryrun_multichip`` on this rank of
    the n-rank ``mesh``, at its tiny shapes and tolerances; returns the
    summary's numbers."""
    import torch.distributed as dist

    from njode_tpu_torch.data import grid
    from njode_tpu_torch.models import njode
    from njode_tpu_torch.ops import fused_scan
    from njode_tpu_torch.parallel import sharding, tensor_parallel
    from njode_tpu_torch.training import group_common, group_sweep
    from njode_tpu_torch.training.steps import make_optimizer, \
        make_sparse_step_fns, make_step_fns

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    fused_scan.reset_launch_counts()
    n = mesh.size
    groups = [dist.new_group([r]) for r in range(n)]
    one = sharding.make_mesh(group=groups[mesh.rank])
    nn16 = ((16, "tanh"),)
    cfg = njode.NJODEConfig(input_size=1, hidden_size=10, output_size=1,
                            ode_nn=nn16, readout_nn=nn16, enc_nn=nn16,
                            dropout_rate=0.1)
    B = 4 * n
    N, K = 4 * B, 8
    dt = 1.0 / K
    rs = np.random.RandomState(0)
    paths = rs.lognormal(0, 0.2, (N, 1, K + 1)).astype(np.float32)
    obs = (rs.random((N, K + 1)) < 0.3).astype(np.float32)
    times = (np.arange(1, K + 1) * dt).astype(np.float32)
    dts = np.full(K, dt, dtype=np.float32)
    d_paths, d_obs, d_times, d_dts = (torch.as_tensor(a, device=dev)
                                      for a in (paths, obs, times, dts))
    idx = torch.arange(B, device=dev)
    out = {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def fresh(c, seed=0):
        model = _seeded_model(c, seed, dev)
        return model, make_optimizer(model.parameters(), 1e-3)

    # 1-vs-n: the full train step (forward, backward, Adam) on a mesh of
    # one and on the n-rank mesh; its loss, the reduced gradients and the
    # parameters after Adam
    def run_step(m, tp=False):
        model, opt = fresh(cfg)
        if tp:
            sharding.shard_model(model, m)
        fns = make_step_fns(model, opt, d_times, d_dts, mesh=m)
        loss = float(fns["train_step"](d_paths, d_obs, idx, 0.5, gen(1)))
        names = [k for k, _ in model.named_parameters()]
        grads = {k: p.grad for k, p in model.named_parameters()}
        params = dict(model.named_parameters())
        if tp:
            grads = tensor_parallel.full_state_dict(model, grads)
            params = tensor_parallel.full_state_dict(model)
        return loss, *(torch.cat([t[k].detach().reshape(-1) for k in names])
                       for t in (grads, params))

    loss_1, g1, p1 = run_step(one)
    loss, gn, pn = run_step(mesh)
    _check("1-vs-n loss", np.isfinite(loss), f"non-finite loss {loss}")
    _close_loss(f"1-vs-{n} loss", loss, loss_1, 1e-5)
    out.update(loss=loss, dloss=abs(loss - loss_1),
               dgrad=_close_params(f"1-vs-{n} grads", gn, g1, GRAD_TOL),
               dparam=_close_params(f"1-vs-{n} params", pn, p1))

    # DP x TP on the 2-D (data, model) mesh, Megatron-style MLP shards
    out["loss_tp"] = loss
    if n >= 2 and n % 2 == 0:
        mesh2 = sharding.make_mesh_2d(n, model_parallel=2)
        loss_tp, g_tp, p_tp = run_step(mesh2, tp=True)
        _check("dp x tp loss", np.isfinite(loss_tp), "non-finite")
        _close_loss("dp x tp loss", loss_tp, loss_1, 1e-4)
        out.update(loss_tp=loss_tp,
                   dgrad_tp=_close_params("dp x tp grads", g_tp, g1,
                                          GRAD_TOL),
                   dparam_tp=_close_params("dp x tp params", p_tp, p1))

    # the explicitly sharded GridBatch eval: eager and K3
    gb = grid.to_torch(grid.recompute_n_obs(grid.batch_from_paths(
        paths[:B], obs[:B].astype(np.int64), dt)), dev)
    model, _ = fresh(cfg)
    with torch.no_grad():
        ref = float(njode.forward(model, gb, train=False)[1])
        loss2 = float(sharding.batch_mean(njode.forward(
            model, sharding.shard_batch(gb, mesh), train=False)[1],
            mesh, B))
    loss3 = float(fused_scan.make_fused_eval_fn(cfg, mesh=mesh)(
        model, gb, 0.5))
    _check("sharded-batch eval", np.isfinite(loss2), "non-finite")
    _close_loss("sharded-batch eval", loss2, ref, 1e-5)
    _close_loss("sharded-batch K3 eval", loss3, ref, 1e-5)
    out.update(loss_eval=loss2, loss_eval_k3=loss3)

    # the real-data path: a masked SparseBatch densified on the device,
    # eager and through the kernels ('input' masks), 1-vs-n each
    cfg_m = njode.NJODEConfig(input_size=1, hidden_size=10, output_size=1,
                              ode_nn=nn16, readout_nn=nn16, enc_nn=nn16,
                              dropout_rate=0.1, masked=True)
    ev = grid.events_from_paths(paths[:B], obs[:B].astype(np.int64), dt)
    ev["batch_size"] = B
    ev["M"] = np.ones_like(ev["X"])
    sb = grid.sparse_to_torch(grid.sparse_from_events(
        ev, dt, 1.0, max_steps=K + 4, max_events=len(ev["obs_idx"]) + 8),
        dev)

    def run_sparse(m, use_kernels):
        model, opt = fresh(cfg_m)
        fns = make_sparse_step_fns(model, opt, use_kernels=use_kernels,
                                   mask_mode="input", mesh=m)
        loss = float(fns["train_step"](sb, 0.5, gen(1), 1.0))
        return loss, _flat(model)

    for tag, kern in (("sparse", False), ("kernel", True)):
        l1, q1 = run_sparse(one, kern)
        ln, qn = run_sparse(mesh, kern)
        _close_loss(f"{tag} 1-vs-{n} loss", ln, l1, 1e-5)
        out[tag] = dict(loss=ln, dloss=abs(ln - l1), dparam=_close_params(
            f"{tag} 1-vs-{n} params", qn, q1))
    _close_loss("kernel-vs-eager loss", out["kernel"]["loss"],
                out["sparse"]["loss"], 1e-4)

    # the grouped ensemble: E = n members split over the mesh, each rank
    # training its members; 1-vs-n member losses and parameters
    E = n
    idx_mat_e = np.stack([
        np.random.RandomState(7 + i).permutation(N)[:2 * B].reshape(2, B)
        for i in range(E)])

    def run_group(m):
        shard = group_common.MemberShard(E, m)
        models, opts = zip(*(fresh(cfg, 100 + e) for e in shard.members))
        fns = group_sweep.make_group_step_fns(list(models), list(opts),
                                              d_times, d_dts)
        losses = fns["train_epoch"](
            d_paths, d_obs,
            torch.as_tensor(idx_mat_e[shard.members], device=dev), 0.5,
            [gen(200 + e) for e in shard.members])
        return (shard.gather(losses, dim=1),
                shard.gather(torch.stack([_flat(x) for x in models])))

    gl1, gp1 = run_group(None)
    gln, gpn = run_group(mesh)
    gdloss = float((gl1 - gln).abs().max())
    _check(f"grouped 1-vs-{n} member losses",
           gdloss <= 1e-5 * max(1.0, float(gl1.abs().max())), gdloss)
    out["group"] = dict(dloss=gdloss, dparam=_close_params(
        f"grouped 1-vs-{n} member params", gpn, gp1))
    out["launches"] = {k: v for k, v in fused_scan.LAUNCHES.items() if v}
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The full training step and its variants over ``n_devices`` ranks
    (``parallel.sharding.spawn``), each checked against one rank, as
    ``__graft_entry__.dryrun_multichip`` does over JAX devices: the 1-vs-n
    step, DP x TP on a 2-D mesh (mp = 2, even n), the sharded-batch eval
    (eager and K3), the masked sparse step eager and through K1/K2
    ('input' masks), and the grouped ensemble. Gloo on the CPU and for
    ranks that share one card; NCCL where there is a card a rank. Prints
    one summary line and returns rank 0's numbers (with its kernel
    launches, ``launches``)."""
    from njode_tpu_torch.parallel import sharding

    dev = _device(device)
    backend = "gloo"
    if dev.type == "cuda":
        from njode_tpu_torch.ops import _build
        _build.build_all(("fused_scan",))    # the ranks load the library
        if torch.cuda.device_count() >= n_devices:
            backend = "nccl"
    res = sharding.spawn(_dryrun_rank, int(n_devices), args=(dev.type,),
                         backend=backend, timeout=300,
                         wait=DRYRUN_TIMEOUT)[0]
    tp = (f"dpxtp loss={res['loss_tp']:.5f}, max|dgrad|="
          f"{res['dgrad_tp']:.3g}, max|dparam|={res['dparam_tp']:.3g}"
          if "dparam_tp" in res else f"dpxtp loss={res['loss_tp']:.5f}")
    print(f"dryrun_multichip({n_devices}, {dev.type}, {backend}): ok, "
          f"loss={res['loss']:.5f}, {tp}, "
          f"sharded-batch loss={res['loss_eval']:.5f} "
          f"(K3 {res['loss_eval_k3']:.5f}); 1-vs-{n_devices} equivalence: "
          f"dloss={res['dloss']:.3g}, max|dgrad|={res['dgrad']:.3g}, "
          f"max|dparam|={res['dparam']:.3g}; "
          f"sparse/masked: dloss={res['sparse']['dloss']:.3g}, "
          f"max|dparam|={res['sparse']['dparam']:.3g}; fused-kernel dp: "
          f"dloss={res['kernel']['dloss']:.3g}, "
          f"max|dparam|={res['kernel']['dparam']:.3g}, vs-eager dloss="
          f"{abs(res['kernel']['loss'] - res['sparse']['loss']):.3g}; "
          f"grouped-ensemble mesh: dloss={res['group']['dloss']:.3g}, "
          f"max|dparam|={res['group']['dparam']:.3g}", flush=True)
    return res


def main(argv):
    # through the module's own name, so that the spawned ranks find
    # _dryrun_rank by it (this file runs as __main__)
    from njode_tpu_torch import entry as this
    from njode_tpu_torch.ops import fused_scan

    if argv[:1] == ["dryrun"]:
        this.dryrun_multichip(int(argv[1]) if len(argv) > 1 else 2)
        return 0
    fn, args = this.entry()
    fused_scan.reset_launch_counts()
    with torch.no_grad():           # a value only: no graph to keep
        loss = float(fn(*args))
    print(f"entry loss: {loss} (launches: "
          f"{ {k: v for k, v in fused_scan.LAUNCHES.items() if v} })",
          flush=True)
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
