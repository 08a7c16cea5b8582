"""Rank functions of the data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_trainers.py). ``parallel.sharding.spawn`` runs
each in processes of their own, which import this module by name: it
imports neither jax nor the JAX package, so a rank starts in seconds."""

import os

import torch
import torch.distributed as dist

from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.ops import fused_gob as fg
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.parallel import multihost, sharding
from njode_tpu_torch.utils.csv_frame import read_frame


def same_across(tensors, mesh):
    """True where every tensor equals rank 0's bit for bit (rank 0's
    broadcast and compared with ``torch.equal``)."""
    ok = True
    for t in tensors:
        ref = t.detach().clone()
        sharding.replicated([ref], mesh)
        ok = ok and torch.equal(ref, t.detach())
    return ok


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


def _njode_step(cfg, state, batch, mode, mesh, seed=11):
    """Loss and gradients of one fused NJODE loss call on ``batch`` (the
    global batch), reduced over ``mesh`` (None: no mesh)."""
    model = tnjode.NJODE(cfg)
    model.load_state_dict(state)
    fn = fs.make_fused_loss_fn(cfg, mode, mesh=mesh)
    loss = fn(model, batch, 0.7, torch.Generator().manual_seed(seed), True)
    loss.backward()
    if mesh is not None:
        loss = sharding.allreduce_grads(list(model.parameters()), mesh,
                                        "mean", loss)
    return loss.detach(), _grads(model), model


def _gob_step(cfg, state, batch, mode, mesh, seed=11):
    model = tgob.GOB(cfg)
    model.load_state_dict(state)
    fn = fg.make_fused_loss_fn(cfg, mode, mesh=mesh)
    loss = fn(model, batch, torch.Generator().manual_seed(seed), True)
    loss.backward()
    if mesh is not None:
        loss = sharding.allreduce_grads(list(model.parameters()), mesh,
                                        "sum", loss)
    return loss.detach(), _grads(model), model


def _bit_equal(a, b):
    return torch.equal(a[0], b[0]) and set(a[1]) == set(b[1]) and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])


def loss_checks(mesh, case, shared):
    """The fused losses and the coordination helpers at two ranks (see
    tests/test_torch_parallel.py for what each entry is held to)."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}
    nj, gb = case["njode"], case["gob"]
    # the global loss and gradients at dropout 0 (against JAX) and 0.1
    out["njode_rate0"] = _njode_step(nj["cfg0"], nj["state"], nj["batch"],
                                     "input", mesh)[:2]
    for mode in ("input", "prng"):
        loss, grads, model = _njode_step(nj["cfg"], nj["state"],
                                         nj["batch"], mode, mesh)
        out[f"njode_{mode}"] = (loss, grads)
        if mode == "prng":
            # one Adam step on the reduced gradient: the same on each rank
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            opt.step()
            out["adam_same"] = same_across(list(model.parameters()), mesh)
    out["gob_rate0"] = _gob_step(gb["cfg0"], gb["state"], gb["batch"],
                                 "input", mesh)[:2]
    out["gob_input"] = _gob_step(gb["cfg"], gb["state"], gb["batch"],
                                 "input", mesh)[:2]
    # the evaluation forms: K3's plain version at an even and an uneven
    # split (4 + 4 and 4 + 3 rows), K5's eval form
    model = tnjode.NJODE(nj["cfg"])
    model.load_state_dict(nj["state"])
    ev = fs.make_fused_eval_fn(nj["cfg"], mesh=mesh)
    out["njode_eval"] = [ev(model, b, 0.7) for b in
                         (nj["batch"], nj["batch7"])]
    gmodel = tgob.GOB(gb["cfg"])
    gmodel.load_state_dict(gb["state"])
    out["gob_eval"] = fg.make_fused_eval_fn(gb["cfg"], mesh=mesh)(
        gmodel, gb["batch"])
    # a batch the mesh does not divide is refused
    try:
        _njode_step(nj["cfg"], nj["state"], nj["batch7"], "input", mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # a mesh of one (each rank its own group) equals no mesh bit for bit
    groups = [dist.new_group([r]) for r in range(mesh.size)]
    one = sharding.make_mesh(group=groups[mesh.rank])
    for mode in ("input", "prng"):
        out[f"one_njode_{mode}"] = _bit_equal(
            _njode_step(nj["cfg"], nj["state"], nj["batch"], mode, one),
            _njode_step(nj["cfg"], nj["state"], nj["batch"], mode, None))
        out[f"one_gob_{mode}"] = _bit_equal(
            _gob_step(gb["cfg"], gb["state"], gb["batch"], mode, one),
            _gob_step(gb["cfg"], gb["state"], gb["batch"], mode, None))
    out["one_eval"] = torch.equal(ev(model, nj["batch7"], 0.7),
                                  fs.make_fused_eval_fn(nj["cfg"], mesh=one)(
                                      model, nj["batch7"], 0.7))
    # the registry and the writes of a run over several processes
    mid, _, saved, resume = multihost.resolve_model_id_synced(
        shared, None, '{"a": 1}', mesh)
    out["registry"] = (mid, resume, saved)

    def _write():
        with open(os.path.join(shared, "once.txt"), "a") as f:
            f.write(f"writer={mesh.rank}\n")
        return mesh.rank

    out["coordinator_only"] = multihost.coordinator_only(_write, mesh=mesh)
    out["broadcast"] = multihost.broadcast_from_coordinator(
        {"rank": mesh.rank}, mesh)
    multihost.barrier("end", mesh)
    return out


def _capture_models(captured):
    """Record the model (and optimizer) every trainer replicates over its
    mesh (``sharding.shard_params``), so that a rank can compare its
    trained parameters with rank 0's."""
    orig = sharding.shard_params

    def shard_params(model, mesh, optimizer=None):
        captured.append(model)
        return orig(model, mesh, optimizer)

    sharding.shard_params = shard_params


def trainer_runs(mesh, jobs, group):
    """Each ``jobs`` entry ``(module, kwargs)`` through
    ``<module>.train(mesh=mesh, **kwargs)``: the result, the metric rows
    (rank 0), and whether the trained parameters equal rank 0's bit for
    bit; then ``group = (params, kwargs)`` through
    ``sweeps.parallel_training(params, vmap_groups=True, group_mesh=mesh,
    **kwargs)``."""
    import importlib

    from njode_tpu_torch.training import sweeps

    torch.set_num_threads(1)
    captured = []
    _capture_models(captured)
    out = {}
    for tag, (module, kw) in jobs.items():
        res = importlib.import_module(module).train(mesh=mesh, **kw)
        rows = None
        if mesh.rank == 0:
            rows = read_frame(os.path.join(kw["saved_models_path"], "id-1",
                                           "metric_id-1.csv"))
        out[tag] = dict(result=res, rows=rows, same=same_across(
            list(captured[-1].parameters()), mesh))
    params, kw = group
    out["group"] = sweeps.parallel_training(
        params=[dict(p) for p in params], vmap_groups=True, group_mesh=mesh,
        **kw)
    return out
