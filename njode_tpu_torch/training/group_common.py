"""Shared machinery of the three grouped sweep paths, the port's copy of
``njode_tpu/training/group_common.py``: ``group_sweep`` (synthetic),
``physionet_group`` (repeats over the record bank), ``climate_group`` (CV
folds over the series bank). The planner, the normal form of param values
for group keys, one device-to-host copy of all members' states per save
event, the per-member artifacts (``id-<id>/`` folders, metric CSVs,
last/best checkpoints in the ``checkpoints`` format), and the group step
that trains E models of one config through the member-axis kernels, and
the split of a group's members over a data mesh (:class:`MemberShard`).

A group keeps one ``NJODE`` module and one ``torch.optim.Adam`` per member,
built as the solo trainer builds them. A step stacks the live members'
leaves and runs K1 and K2 once each over the member axis
(``fused_scan.make_fused_members_loss_fn``), then steps each live member's
own optimizer; a member with no batch at a step (a padding batch, a
shorter fold) skips its ``optimizer.step()``, so its weights, its Adam
moments and its step count stay as they were."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from njode_tpu_torch.models import njode
from njode_tpu_torch.parallel import sharding
from njode_tpu_torch.training import checkpoints
from njode_tpu_torch.utils.csv_frame import write_frame
from njode_tpu_torch.utils.paths import makedirs


def plan_groups(params_list, group_key, min_group=2):
    """Partition a sweep into (groups, singles): ``groups`` is a list of
    index lists (each a group of >= ``min_group`` members sharing
    ``group_key``), ``singles`` the remaining indices in ascending order
    (ungroupable or lone runs: the solo path)."""
    buckets = {}
    singles = []
    for i, p in enumerate(params_list):
        k = group_key(p)
        if k is None:
            singles.append(i)
        else:
            buckets.setdefault(k, []).append(i)
    groups = []
    for idxs in buckets.values():
        if len(idxs) >= min_group:
            groups.append(idxs)
        else:
            singles.extend(idxs)
    return groups, sorted(singles)


def norm_val(k, v, nn_keys):
    """Hashable normal form of a param value for group keys (net specs
    to ((width, act), ...) tuples; lists to tuples recursively)."""
    if k in nn_keys:
        return tuple((int(w), str(a)) for w, a in v) if v else v
    if isinstance(v, (list, tuple)):
        return tuple(norm_val(k, x, nn_keys) for x in v)
    return v


def norm_nn(nn):
    """A net spec as ``((width, act), ...)`` (JSON turns tuples into
    lists)."""
    return None if nn is None else tuple((int(w), str(a)) for w, a in nn)


def _walk(obj, fn):
    """``obj`` with ``fn`` applied to every tensor (dicts, lists and tuples
    rebuilt in their own type, a state dict's ``_metadata`` kept)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        out = type(obj)((k, _walk(v, fn)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(v, fn) for v in obj)
    return obj


def member_states(states):
    """``states`` (one ``(model state, optimizer state)`` pair per member,
    e.g. ``checkpoints.snapshot`` of each) on the host, with one
    device-to-host copy for all of them: the float32 device tensors are
    packed into one buffer, copied once and split back (one copy per
    tensor costs a round trip each, which dominated the JAX package's
    grouped saves; the counterpart of its ``member_slice`` of one fetched
    tree). Member i's pair is ``result[i]``."""
    dev = [t for t in _flat_tensors(states)
           if t.device.type != "cpu" and t.dtype == torch.float32]
    if not dev:
        return _walk(states, lambda t: t.detach().clone())
    host = torch.cat([t.detach().reshape(-1) for t in dev]).cpu()
    views, off = {}, 0
    for t in dev:
        views[id(t)] = host[off:off + t.numel()].view(t.shape)
        off += t.numel()
    return _walk(states, lambda t: views[id(t)] if id(t) in views
                 else t.detach().cpu().clone())


def _flat_tensors(obj):
    out = []
    _walk(obj, lambda t: out.append(t) or t)
    return out


class MemberShard:
    """The members of a group that this process trains. Without a ``mesh``:
    all E. Under a mesh (``parallel.sharding.Mesh``) the group is padded to
    a multiple of the mesh size with ghost copies of its last member (the
    JAX package's ghost padding) and split in contiguous blocks of slots,
    rank r training its block (``members``: the member each slot trains).
    The members are independent, so training needs no collective;
    :meth:`gather` brings every member's values to every rank and
    :meth:`gather_states` their states to rank 0, the ``writer``, ghosts
    dropped."""

    def __init__(self, E, mesh=None):
        self.E, self.mesh = E, sharding.check_mesh(mesh)
        n = 1 if mesh is None else mesh.size
        self.n_slots = -(-E // n) * n
        lo, hi = (0, E) if mesh is None else mesh.rows(self.n_slots)
        self.members = [min(i, E - 1) for i in range(lo, hi)]
        self.writer = mesh is None or mesh.rank == 0

    def take(self, seq):
        """``seq``'s entries of this rank's slots."""
        return [seq[i] for i in self.members]

    def gather(self, t, dim=0):
        """Every member's values along ``dim`` from this rank's slots'."""
        if self.mesh is None:
            return t
        return sharding.gather_rows(t, self.mesh, self.n_slots,
                                    dim).narrow(dim, 0, self.E)

    def gather_states(self, states):
        """``states`` (this rank's slots' (model, optimizer) state pairs)
        on the host (:func:`member_states`): every member's on the writer,
        None on the other ranks."""
        host = member_states(states)
        if self.mesh is None:
            return host
        parts = [None] * self.mesh.size if self.writer else None
        dist.gather_object(host, parts, dst=self.mesh.coordinator,
                           group=self.mesh.group)
        return ([s for part in parts for s in part][:self.E] if self.writer
                else None)


class MemberArtifacts:
    """Per-member artifacts in the solo trainers' layout: ``id-<model_id>/``
    with last/best checkpoint slots and ``metric_id-<id>.csv``, rows kept
    per member and written on :meth:`flush` (the solo trainers' cadence).
    Where ``writer`` is False (a rank of a mesh other than 0) nothing is
    written."""

    def __init__(self, group_params, saved_models_path, columns,
                 writer=True):
        self.columns = list(columns)
        self.writer = writer
        self.model_dirs, self.metric_files, self.rows = [], [], []
        self.pending = []
        for p in group_params:
            mdir = os.path.join(saved_models_path, f"id-{p['model_id']}")
            if writer:
                makedirs(os.path.join(mdir, "last_checkpoint"))
                makedirs(os.path.join(mdir, "best_checkpoint"))
            self.model_dirs.append(mdir)
            self.metric_files.append(os.path.join(
                mdir, f"metric_id-{p['model_id']}.csv"))
            self.rows.append([])
            self.pending.append(False)

    def append(self, i, row):
        self.rows[i].append(row)
        self.pending[i] = True

    def flush(self, i):
        if self.writer:
            write_frame(self.metric_files[i], self.columns, self.rows[i])
        self.pending[i] = False

    def flush_pending(self):
        for i, p in enumerate(self.pending):
            if p:
                self.flush(i)

    def ckpt_dir(self, i, slot):
        return os.path.join(self.model_dirs[i], slot)

    def save(self, i, slot, state, epoch, weight):
        """Write member i's ``(model state, optimizer state)`` to ``slot``
        ('last_checkpoint' or 'best_checkpoint')."""
        if self.writer:
            checkpoints.save_state(self.ckpt_dir(i, slot), *state, epoch,
                                   weight)


def record_epoch(arts, shard, rows, metric, best, epoch, weight, save_every,
                 states):
    """The real-data groups' writes of one epoch: member i's ``rows[i]``
    appended; its best checkpoint where ``metric[i]`` beats ``best[i]``
    (then updated); its rows flushed and its last checkpoint written on
    the ``save_every`` cadence. ``states()``: this rank's slots'
    (model, optimizer) state pairs, brought to the writer once and only
    where a slot is written (``shard.gather_states``)."""
    save_last = epoch % save_every == 0
    for i, row in enumerate(rows):
        arts.append(i, row)
    saving = [i for i in range(shard.E) if save_last or metric[i] < best[i]]
    host = shard.gather_states(states()) if saving else None
    for i in saving:
        if metric[i] < best[i]:
            if host is not None:
                arts.save(i, "best_checkpoint", host[i], epoch, weight)
            best[i] = metric[i]
        if save_last:
            arts.flush(i)
            if host is not None:
                arts.save(i, "last_checkpoint", host[i], epoch, weight)


def make_group_step(models, optimizers, use_kernels, mask_mode="prng"):
    """``step(batches, weight, generators, live, loss_scales=None)``: one
    training step of the members ``live`` (indices into ``models``, one
    config) on their ``batches`` (GridBatches, one per live member), each
    drawing from its own generator; returns their losses (times
    ``loss_scales``, a list of floats, one per live member) as a device
    tensor ``[len(live)]``.

    ``use_kernels``: one member-axis launch of K1 and of K2 for the live
    members (``fused_scan.make_fused_members_loss_fn``; their plain
    versions on the CPU), then each live member's own optimizer step.
    Else (the eager route) each member takes the solo eager step,
    ``njode.forward``, one after another. Either way member e's loss and
    update are the solo trainer's."""
    members_loss = None
    if use_kernels:
        from njode_tpu_torch.ops import fused_scan
        members_loss = fused_scan.make_fused_members_loss_fn(
            models[0].cfg, mask_mode)

    def step(batches, weight, generators, live, loss_scales=None):
        for e in live:
            optimizers[e].zero_grad(set_to_none=True)
        scales = loss_scales if loss_scales is not None else [1.0] * len(
            live)
        if members_loss is None:
            losses = []
            for e, batch, gen, ls in zip(live, batches, generators, scales):
                loss = njode.forward(models[e], batch, weight=weight,
                                     train=True, generator=gen)[1] * ls
                loss.backward()
                losses.append(loss.detach())
            loss_e = torch.stack(losses)
        else:
            raw = members_loss([models[e] for e in live], batches, weight,
                               generators, True)
            scaled = raw * torch.tensor(scales, dtype=raw.dtype,
                                        device=raw.device)
            scaled.sum().backward()
            loss_e = scaled.detach()
        for e in live:
            optimizers[e].step()
        return loss_e

    return step
