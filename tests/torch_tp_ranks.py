"""Rank function of tests/test_torch_tensor_parallel.py, run by
``parallel.sharding.spawn`` in processes of their own, which import this
module by name: it imports neither jax nor the JAX package."""

import copy

import torch

from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.parallel import sharding, tensor_parallel
from njode_tpu_torch.training.steps import make_optimizer, make_step_fns


def _model(cfg, state):
    model = tnjode.NJODE(cfg)
    model.load_state_dict(state)
    return model


def _eval(cfg, state, batch, mesh):
    model = sharding.shard_model(_model(cfg, state), mesh)
    with torch.no_grad():
        return float(tnjode.forward(model, batch, train=False)[1])


def tp_step(cfg, state, data, mesh, seed=5):
    """One train step of the sharded model over the 2-D ``mesh``: its
    loss, the full gradients and the full parameters after Adam."""
    model = _model(cfg, state)
    opt = make_optimizer(model.parameters(), 1e-2)
    sharding.shard_model(model, mesh, opt)
    fns = make_step_fns(model, opt, data["times"], data["dts"], mesh=mesh)
    loss = fns["train_step"](data["paths"], data["obs"], data["idx"], 0.5,
                             torch.Generator().manual_seed(seed))
    grads = tensor_parallel.full_state_dict(
        model, {k: p.grad for k, p in model.named_parameters()})
    return loss, grads, tensor_parallel.full_state_dict(model)


def solo_step(cfg, state, data, seed=5, steps=1, model=None, opt=None):
    """The port's unsharded step(s), the generator seeded as the ranks'."""
    if model is None:
        model = _model(cfg, state)
        opt = make_optimizer(model.parameters(), 1e-2)
    fns = make_step_fns(model, opt, data["times"], data["dts"])
    for s in range(steps):
        loss = fns["train_step"](data["paths"], data["obs"], data["idx"],
                                 0.5, torch.Generator().manual_seed(seed + s))
    return loss, {k: p.grad.clone() for k, p in model.named_parameters()}, \
        model.state_dict(), model, opt


def tp_checks(mesh, case):
    """Every multi-rank check of the test file at 4 ranks."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}
    mesh2 = sharding.make_mesh_2d(4, model_parallel=2)
    mesh4 = sharding.make_mesh_2d(4, model_parallel=4)
    out["layout"] = (mesh2.data.rank, mesh2.model.rank, mesh2.data.size,
                     mesh4.data.size, mesh4.model.rank)
    s16, main = case["s16"], case["main"]
    out["eval16"] = [_eval(s16["cfg"], s16["state"], s16["batch"], m)
                     for m in (mesh2, mesh4)]
    out["eval_main"] = _eval(main["cfg"], main["state"], s16["batch"],
                             mesh2)
    st = case["step"]
    out["step0"] = tp_step(st["cfg0"], st["state"], st["data"], mesh2)
    out["step_drop"] = tp_step(st["cfg"], st["state"], st["data"], mesh2)
    # bf16 products, the model split 4 ways (a 1 x 4 mesh: the data axis
    # would round each data rank's partial weight gradient on its own)
    out["step_bf16"] = tp_step(st["cfg_bf16"], st["state"], st["data"],
                               mesh4)
    # Adam state carried into the shards: one unsharded step, the model and
    # its optimizer cut, a second step; against two unsharded steps
    _, _, _, model, opt = solo_step(st["cfg"], st["state"], st["data"])
    model, opt = copy.deepcopy((model, opt))
    sharding.shard_model(model, mesh2, opt)
    make_step_fns(model, opt, st["data"]["times"], st["data"]["dts"],
                  mesh=mesh2)["train_step"](
        st["data"]["paths"], st["data"]["obs"], st["data"]["idx"], 0.5,
        torch.Generator().manual_seed(6))
    out["adam_carried"] = tensor_parallel.full_state_dict(model)
    # what is refused
    errs = {}
    for tag, fn in (
            ("mp3", lambda: sharding.make_mesh_2d(4, model_parallel=3)),
            ("kernels", lambda: make_step_fns(
                model, opt, st["data"]["times"], st["data"]["dts"],
                use_kernels=True, mesh=mesh2)),
            ("uncut", lambda: make_step_fns(
                _model(st["cfg"], st["state"]), opt, st["data"]["times"],
                st["data"]["dts"], mesh=mesh2))):
        try:
            fn()
            errs[tag] = None
        except ValueError as e:
            errs[tag] = str(e)
    out["errors"] = errs
    return out
