"""Coordination of the filesystem side effects of a run over several
processes, the port's copy of ``njode_tpu/parallel/multihost.py``.

Every rank of a data-parallel run runs the same program, so the registry,
metric and checkpoint writes must be (a) made once and (b) agreed on by
every rank: the coordinator (rank 0) makes the write, the result is
broadcast over ``torch.distributed``, and a barrier keeps the ranks in
step. Each function takes the run's ``mesh`` (its process group; default
the whole default group) and does nothing collective in a single process
or on a mesh of one, so the trainers call them unconditionally."""

from __future__ import annotations

import json

import torch.distributed as dist


def _group(mesh):
    return None if mesh is None else mesh.group


def process_count(mesh=None) -> int:
    if mesh is not None:
        return mesh.size
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index(mesh=None) -> int:
    if mesh is not None:
        return mesh.rank
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator(mesh=None) -> bool:
    """True on the process that owns the filesystem side effects."""
    return process_index(mesh) == 0


def barrier(name: str = "njode_barrier", mesh=None):
    """Block until every rank arrives (nothing in a single process).
    ``name`` labels the call site, as the JAX function's does."""
    if process_count(mesh) > 1:
        dist.barrier(group=_group(mesh))


def broadcast_from_coordinator(value, mesh=None):
    """``value`` of rank 0 (any picklable object) on every rank."""
    if process_count(mesh) == 1:
        return value
    obj = [value]
    src = 0 if mesh is None else mesh.coordinator
    dist.broadcast_object_list(obj, src=src, group=_group(mesh))
    return obj[0]


def coordinator_only(fn, *args, mesh=None, **kwargs):
    """Run a side-effecting ``fn`` (registry, metric or file writes) on
    rank 0 only, then synchronise. The return value is rank 0's (None on
    the others); to agree on a value use :func:`broadcast_from_coordinator`
    or :func:`resolve_model_id_synced`."""
    result = fn(*args, **kwargs) if is_coordinator(mesh) else None
    barrier("coordinator_only", mesh)
    return result


def resolve_model_id_synced(saved_models_path, model_id, desc, mesh=None):
    """``registry.resolve_model_id`` for several ranks: rank 0 touches
    ``model_overview.csv``, every rank gets the same ``(model_id,
    resume)``, and the description is read back from the registry on the
    shared filesystem after the barrier rather than broadcast."""
    from njode_tpu_torch.training import registry

    if process_count(mesh) == 1:
        return registry.resolve_model_id(saved_models_path, model_id, desc)
    payload = None
    if is_coordinator(mesh):
        mid, _, _, resume = registry.resolve_model_id(
            saved_models_path, model_id, desc)
        payload = (int(mid), bool(resume))
    mid, resume = broadcast_from_coordinator(payload, mesh)
    barrier("resolve_model_id", mesh)
    rows = registry.load_overview(saved_models_path)
    saved_desc = next(d for i, d in rows if i == mid)
    return (mid, saved_desc, json.loads(saved_desc) if resume else None,
            resume)
