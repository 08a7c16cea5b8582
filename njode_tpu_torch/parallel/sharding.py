"""Data and tensor parallelism over ``torch.distributed``, the port's copy
of ``njode_tpu/parallel/sharding.py``.

The JAX package runs one process over several devices; here every rank is a
process of its own running the whole program. A :class:`Mesh` is this
process's place in a 1-D process group over the 'data' axis. Rank r holds
the contiguous block r of every batch's rows (:func:`shard_batch`, the
layout ``P('data')`` gives), parameters and optimizer state are replicated
(:func:`shard_params`), and after each backward the flat gradient is summed
or averaged over the ranks in one collective (:func:`allreduce_grads`), so
that every rank takes the same optimizer step. The JAX package gets that
all-reduce from ``shard_map``'s transpose; here the step functions call it.

Tensor parallelism: :func:`make_mesh_2d` lays the ranks out as a (data x
model) grid, :func:`ffnn_tp_specs` and :func:`njode_tp_sharding` give the
JAX package's Megatron-style specs of each MLP layer, and
:func:`shard_model` cuts a replicated ``NJODE`` (and its Adam state) down
to this rank's shards. ``parallel/tensor_parallel.py`` runs the sharded
MLPs (what GSPMD does for the JAX forward).

Backends are chosen by the caller, never switched silently: 'nccl' (one
card a rank) or 'gloo' (CPU tensors, and CUDA tensors for all_reduce and
broadcast, so two ranks may share one card, which NCCL refuses). Only
all_reduce, broadcast and the object collectives are used; both backends
have them. :func:`spawn` starts the ranks as fresh interpreters ('spawn',
never 'fork', which CUDA does not survive) with a file store for the
rendezvous (no network)."""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

# how long a collective waits for its peers: a rank that died fails the
# others within this time instead of hanging them
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def initialize_distributed(backend: str = "gloo", init_method=None,
                           world_size=None, rank=0,
                           timeout=DEFAULT_TIMEOUT) -> bool:
    """Join a process group (``dist.init_process_group``) as ``rank`` of
    ``world_size``; nothing happens in a single process (no
    ``world_size``) or where a group is already initialised. Under 'nccl'
    the process takes card ``rank % device_count``. Returns True where a
    group is initialised.

    :param init_method: the rendezvous, e.g. ``file:///path`` or
        ``tcp://127.0.0.1:<port>``
    :param timeout: a ``datetime.timedelta`` or seconds; how long a
        collective waits for its peers before it fails
    """
    if dist.is_initialized():
        return True
    if world_size is None:
        return False
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=timeout)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the 'data' axis: ``size`` ranks of the process
    ``group`` (None: the default group), this process being ``rank``."""
    size: int
    rank: int
    group: Any = None

    @property
    def coordinator(self) -> int:
        """The global rank of the mesh's rank 0 (the collectives' source)."""
        return 0 if self.group is None else dist.get_global_rank(
            self.group, 0)

    def rows(self, n: int):
        """``(start, stop)`` of this rank's block of ``n`` rows: contiguous
        blocks in rank order, the first ``n % size`` one row longer (an
        even split where ``size`` divides ``n``)."""
        base, extra = divmod(int(n), self.size)
        start = self.rank * base + min(self.rank, extra)
        return start, start + base + int(self.rank < extra)


def make_mesh(n_devices=None, group=None) -> Mesh:
    """The 1-D mesh over ``group`` (default: every process of the
    initialised default group). ``n_devices``, where given, must be the
    group's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first (or run under "
                           "parallel.sharding.spawn)")
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks")
    return Mesh(size, dist.get_rank(group), group)


def check_mesh(mesh, what: str = "data parallelism"):
    """``mesh`` where it is a :class:`Mesh` or None, else ValueError (a
    :class:`Mesh2D` with the JAX package's message for ``what``)."""
    if isinstance(mesh, Mesh2D):
        raise ValueError(f"{what} needs a 1-D mesh over 'data'; got axes "
                         f"{mesh.axis_names}")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"{what} needs a 1-D "
                         "njode_tpu_torch.parallel.sharding.Mesh over "
                         f"'data' (make_mesh); got {type(mesh).__name__}")
    return mesh


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D (data x model) mesh of ``shape = (n // mp, mp)`` ranks: global
    rank r sits at data index ``r // mp`` and model index ``r % mp`` (the
    layout of the JAX package's ``reshape(n // mp, mp)``). ``data`` is the
    1-D :class:`Mesh` over this rank's column (the ranks of its model
    index, which split the batch rows), ``model`` the one over its row (the
    ranks of its data index, which split the MLP weights)."""
    shape: tuple
    data: Mesh
    model: Mesh
    axis_names: tuple = ("data", "model")


def make_mesh_2d(n_devices=None, model_parallel: int = 1,
                 axes=("data", "model")) -> Mesh2D:
    """The 2-D (data x model) mesh over every process of the initialised
    default group, for data and tensor parallelism at once. Every rank
    creates every subgroup (``dist.new_group``) in the same order: first
    one a row (the 'model' groups), then one a column (the 'data' groups).
    ``n_devices``, where given, must be the world size; ``model_parallel``
    must divide it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs a process group: call "
                           "initialize_distributed first (or run under "
                           "parallel.sharding.spawn)")
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"make_mesh_2d({n_devices}): the process group "
                         f"has {n} ranks")
    mp = int(model_parallel)
    if mp < 1 or n % mp:
        raise ValueError(f"model_parallel={mp} does not divide the {n} "
                         "ranks")
    rows = n // mp
    model_groups = [dist.new_group([i * mp + j for j in range(mp)])
                    for i in range(rows)]
    data_groups = [dist.new_group([i * mp + j for i in range(rows)])
                   for j in range(mp)]
    di, mi = divmod(dist.get_rank(), mp)
    return Mesh2D((rows, mp), Mesh(rows, di, data_groups[mi]),
                  Mesh(mp, mi, model_groups[di]), tuple(axes))


def ffnn_tp_specs(layers, axis: str = "model", axis_size: int = 1):
    """Megatron-style tensor-parallel specs of an MLP's layers (``nn.Linear``
    modules, or a ``get_ffnn`` Sequential), in the JAX package's ``[in,
    out]`` orientation, each spec the tuple
    ``tuple(PartitionSpec(...))`` gives: even layers shard the output dim
    (``w (None, axis)``, bias ``(axis,)``), odd layers the input dim (``w
    (axis, None)``, bias replicated ``()``); a layer whose dim
    ``axis_size`` does not divide stays replicated. Torch's ``[out, in]``
    weights slice the transposed dim (:func:`shard_model`)."""
    if isinstance(layers, torch.nn.Sequential):
        layers = [m for m in layers if isinstance(m, torch.nn.Linear)]
    specs = []
    for i, lin in enumerate(layers):
        d_out, d_in = lin.weight.shape
        if i % 2 == 0 and d_out % axis_size == 0:
            s = {"w": (None, axis), "b": (axis,)}
        elif i % 2 == 1 and d_in % axis_size == 0:
            s = {"w": (axis, None), "b": ()}
        else:
            s = {"w": (), "b": ()}
        if lin.bias is None:
            del s["b"]
        specs.append(s)
    return specs


# the module paths of NJODE's MLP stacks (the JAX pytree's 'ode_f',
# 'encoder' and 'readout')
TP_NETS = ("ode_f.f", "encoder_map.ffnn", "readout_map.ffnn")


def _tp_nets(model, axis, size):
    """``(path, Sequential, [name of each Linear], ffnn_tp_specs)`` for each
    MLP stack of ``model``: the one place that maps a layer to its
    parameters' names."""
    for path in TP_NETS:
        seq = model.get_submodule(path)
        names = [f"{path}.{k}" for k, m in seq.named_children()
                 if isinstance(m, torch.nn.Linear)]
        yield path, seq, names, ffnn_tp_specs(seq, axis, size)


def njode_tp_sharding(model, mesh: Mesh2D, axis: str = "model"):
    """The spec of every parameter of ``model`` (an ``NJODE``) by its
    ``state_dict`` name: the three MLP stacks tensor-parallel over
    ``axis`` (:func:`ffnn_tp_specs`), everything else (the GRU jump
    ``obs_c.*``) replicated, ``()``."""
    size = dict(zip(mesh.axis_names, mesh.shape))[axis]
    specs = {name: () for name, _ in model.named_parameters()}
    for _, _, names, layer_specs in _tp_nets(model, axis, size):
        for name, s in zip(names, layer_specs):
            specs[f"{name}.weight"] = s["w"]
            if "b" in s:
                specs[f"{name}.bias"] = s["b"]
    return specs


def shard_dim(spec, torch_weight: bool) -> Optional[int]:
    """The torch dim a spec shards: a weight's JAX ``[in, out]`` dims are
    torch's ``[out, in]`` transposed; None where nothing is sharded."""
    if not any(spec):
        return None
    d = [i for i, a in enumerate(spec) if a is not None][0]
    return 1 - d if torch_weight else d


@dataclasses.dataclass(frozen=True)
class TPState:
    """What :func:`shard_model` leaves on a cut ``NJODE`` (``model.tp``):
    its mesh and every parameter's spec (:func:`njode_tp_sharding`)."""
    mesh: Mesh2D
    specs: dict


def shard_model(model, mesh: Mesh2D, optimizer=None):
    """Cut a replicated ``NJODE`` (and the Adam state of ``optimizer``) down
    to this rank's shards over the mesh's 'model' axis, in place: each
    sharded parameter keeps block ``mesh.model.rank`` of its sharded dim
    (even blocks: the spec rule shards only dims the axis size divides),
    each MLP stack carries its plan (``tensor_parallel.TPPlan``), which
    ``models/mlp.ffnn_apply`` follows, and ``model.tp`` the
    :class:`TPState`. A bf16 config (``compute_dtype='bfloat16'``) runs the
    same shards with bf16 products. Returns ``model``."""
    from njode_tpu_torch.parallel import tensor_parallel

    axis, sub = mesh.axis_names[1], mesh.model
    specs = njode_tp_sharding(model, mesh, axis)
    plans = [(seq, tensor_parallel.TPPlan.of(seq, layer_specs, sub))
             for _, seq, _, layer_specs in _tp_nets(model, axis, sub.size)]
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = shard_dim(specs[name], name.endswith("weight"))
            if d is None:
                continue
            lo, hi = sub.rows(p.shape[d])
            state = optimizer.state.get(p, {}) if optimizer else {}
            for k, v in state.items():
                if torch.is_tensor(v) and v.shape == p.shape:
                    state[k] = v.narrow(d, lo, hi - lo).clone()
            p.data = p.data.narrow(d, lo, hi - lo).clone()
    for seq, plan in plans:
        seq.tp_plan = plan
    model.tp = TPState(mesh, specs)
    return model


def check_divisible(n: int, mesh: Mesh):
    """ValueError unless the mesh size divides a batch of ``n`` rows."""
    if n % mesh.size:
        raise ValueError(f"batch {n} is not divisible by the "
                         f"{mesh.size}-way mesh")


def _nccl(mesh) -> bool:
    return dist.get_backend(mesh.group) == "nccl"


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, a new tensor on ``t``'s device (a
    CPU tensor travels through the card under NCCL)."""
    buf = t.detach().clone()
    if _nccl(mesh) and buf.device.type != "cuda":
        buf = buf.cuda()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device)


def replicated(tensors, mesh: Mesh):
    """Broadcast each tensor from the mesh's rank 0, in place."""
    src = mesh.coordinator
    with torch.no_grad():
        for t in tensors:
            buf = t.detach()
            if _nccl(mesh) and buf.device.type != "cuda":
                buf = buf.cuda()
            dist.broadcast(buf, src=src, group=mesh.group)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)


def shard_params(model, mesh: Mesh, optimizer=None):
    """Replicate ``model``'s parameters and buffers, and ``optimizer``'s
    state tensors, from rank 0 (the counterpart of ``device_put`` to
    ``P()``); returns ``model``."""
    ts = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        ts += [v for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v)]
    replicated(ts, mesh)
    return model


def allreduce_grads(params, mesh: Mesh, op: str = "mean", loss=None):
    """Reduce the gradients of ``params`` over the mesh in one collective:
    the flat gradient (and ``loss``, a scalar, at its end) summed over the
    ranks and, for 'mean', divided by the mesh size; each ``.grad`` takes
    its reduced value. Parameters without a gradient are left out (no rank
    has one: the ranks run one program). Returns the reduced loss, or None.

    'mean' is the NJODE loss's, a batch mean (the JAX package's ``pmean``):
    each rank's loss divides by its own rows, so the mean over equal blocks
    is the global batch's loss and gradient. 'sum' is the GRU-ODE-Bayes
    loss's, a sum over observations (``psum``)."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads]
    if loss is not None:
        parts.append(loss.detach().reshape(1))
    flat = all_reduce(torch.cat(parts), mesh)
    if op == "mean":
        flat = flat / mesh.size
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[-1] if loss is not None else None


def shard_rows(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``t``'s rows along ``dim``, contiguous."""
    lo, hi = mesh.rows(t.shape[dim])
    return t.narrow(dim, lo, hi - lo).contiguous()


def gather_rows(t: torch.Tensor, mesh: Mesh, n: int, dim: int = 0):
    """All ``n`` rows along ``dim`` on every rank, from each rank's block
    ``t`` (:meth:`Mesh.rows`): the blocks placed in a zero tensor and
    summed over the ranks (exact: every element is one block's value plus
    zeros)."""
    lo, hi = mesh.rows(n)
    shape = list(t.shape)
    shape[dim] = n
    full = t.new_zeros(shape)
    full.narrow(dim, lo, hi - lo).copy_(t)
    return all_reduce(full, mesh)


def batch_mean(loss: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The batch-mean loss of ``n`` rows from this rank's loss over its
    block (:meth:`Mesh.rows`, a mean over its own rows): the blocks'
    losses weighted by their shares of the rows and summed over the ranks
    (a mesh of one returns ``loss`` as it is)."""
    lo, hi = mesh.rows(n)
    return all_reduce(loss * ((hi - lo) / n), mesh)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a GridBatch (a densified SparseBatch too, where
    the JAX package's ``constrain_batch`` pins one built inside jit): the
    layout is time-major, so ``obs [K,B]`` and ``X``/``M [K,B,D]`` split on
    axis 1, ``start_X [B,D]`` and ``n_obs_ot [B]`` on axis 0, and the grid
    (``times``/``dt``) is replicated."""
    return batch._replace(
        obs=shard_rows(batch.obs, mesh, 1), X=shard_rows(batch.X, mesh, 1),
        M=shard_rows(batch.M, mesh, 1),
        start_X=shard_rows(batch.start_X, mesh, 0),
        n_obs_ot=shard_rows(batch.n_obs_ot, mesh, 0))


def _rank_main(rank, fn, world_size, backend, init_method, timeout, out_dir,
               args):
    initialize_distributed(backend, init_method, world_size, rank, timeout)
    try:
        out = fn(make_mesh(), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), backend: str = "gloo",
          timeout=DEFAULT_TIMEOUT, wait=None):
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes ('spawn'
    start method), one rank each, over a process group of ``backend``;
    returns the ranks' return values (saved with ``torch.save``) in rank
    order. ``fn`` must be importable by name from a module the children
    can import. A rank that raises or exits with another code than 0
    fails the call (the others are terminated), and so does ``wait``
    seconds passing. Build the CUDA kernels before spawning
    (``ops._build.build_all``): the ranks then load the cached libraries."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="njode_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend,
                              "file://" + os.path.join(tmp, "store"),
                              timeout, tmp, tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if wait is None else time.monotonic() + wait
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
                raise TimeoutError(f"spawn: the {world_size} ranks did not "
                                   f"end within {wait} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
