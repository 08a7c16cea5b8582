"""Grouped ensembles of a synthetic sweep, the port's copy of
``njode_tpu/training/group_sweep.py``.

:func:`plan_groups` partitions a reconciled sweep param list into groups
of runs of ONE architecture (widths included) that differ only in their
seeds (``seed``, ``repeat_seed``) and ids, and :func:`train_group` trains
one group as an ensemble on the card with the solo trainer's artifacts per
member: ``metric_id-<id>.csv`` (the same columns, ``evaluation_mean_diff``
included), last/best checkpoints in the ``checkpoints`` format, the shared
registry untouched (ids are assigned by ``sweeps.parallel_training``
before any run starts).

The training steps go through K1 and K2 over a member axis: one launch of
each for all members a step (``group_common.make_group_step``), where the
JAX package ``jax.vmap``s its Pallas kernel. Each member keeps the port's
solo streams (``training/trainer.py``): the numpy split and subsample,
``NJODE`` initialised under ``torch.manual_seed(rseed)``, the shuffle
``RandomState(rseed * 100_003 + epoch)`` and the epoch's
``torch.Generator`` seeded ``(rseed + 1) * 100_003 + epoch``, from which a
step draws the encoder's masks and then the Philox seed. So a member's
losses, weights and checkpoints are its solo run's, bit for bit on the
card (one launch sums each member in a solo launch's order) and on the
CPU (the plain versions). The evaluation runs each member as the solo
trainer does (K3, one launch a member; the oracle's mean squared
difference eager). Deviations, as in the JAX package: no per-epoch plots
(draw them from the checkpoints), and ``train_time``/``eval_time`` are the
group's wall time divided by E. Under a ``mesh`` the members split over
the ranks (``group_common.MemberShard``: ghost copies of the last member
pad the group to a multiple of the mesh size), each rank training its
members through one member-axis launch a step; rank 0 gathers every
member's row and state and writes the artifacts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from njode_tpu_torch.data import datasets as du
from njode_tpu_torch.data import oracle, sde
from njode_tpu_torch.data.grid import batch_from_paths, recompute_n_obs, \
    to_torch
from njode_tpu_torch.models import njode
from njode_tpu_torch.training import checkpoints, group_common
from njode_tpu_torch.training.steps import gather_dense_batch, \
    make_optimizer, make_step_fns
from njode_tpu_torch.training.trainer import HIST_BUDGET, METR_COLUMNS, \
    train_val_split
from njode_tpu_torch.utils import paths as path_cfg

SYNTHETIC_DATASETS = ("BlackScholes", "Heston", "OrnsteinUhlenbeck",
                      "HestonWOFeller", "sine_BlackScholes", "sine_Heston",
                      "sine_OrnsteinUhlenbeck")

# Every key train_group reads from the first member (so members must
# agree), with the default it reads it with; any key outside _MATCH_KEYS,
# _VARY_KEYS and _INERT_KEYS makes an entry ungroupable (the solo path,
# where every option is honoured), so an option the grouped path does not
# implement (ema_decay, ...) is never dropped. The JAX package's TPU-only
# keys that the port's solo trainer ignores (pallas_interpret, use_orbax,
# orbax_async) are inert here, so the port groups the same published
# entries as the JAX planner; epoch_chunk_hist_bytes, which the epoch_chunk
# loop reads, must match as it does there.
_MATCH_KEYS = (
    ("dataset", "BlackScholes"), ("dataset_id", None), ("epochs", 100),
    ("batch_size", 100), ("save_every", 1), ("learning_rate", 1e-3),
    ("test_size", 0.2), ("training_size", None), ("hidden_size", 10),
    ("bias", True), ("dropout_rate", 0.1), ("ode_nn", None),
    ("readout_nn", None), ("enc_nn", None), ("use_rnn", False),
    ("solver", "euler"), ("weight", 0.5), ("weight_decay", 1.0),
    ("saved_models_path", None), ("base_data_path", None),
    ("evaluate", False), ("which_loss", "standard"),
    ("residual_enc_dec", True), ("input_current_t", False),
    ("masked", False), ("compute_dtype", "float32"),
    ("use_pallas", None), ("pallas_mask_mode", "prng"),
    ("epoch_chunk", 0), ("epoch_chunk_hist_bytes", HIST_BUDGET),
    ("device", "cuda"))
_VARY_KEYS = ("seed", "model_id", "repeat_seed")
_INERT_KEYS = ("other_model", "func_appl_X", "resume_training",
               "plot_only", "plot", "paths_to_plot", "parallel",
               "pallas_interpret", "use_orbax", "orbax_async")
_NN_KEYS = ("ode_nn", "readout_nn", "enc_nn")


def _norm_val(k, v):
    return group_common.norm_val(k, v, _NN_KEYS)


def group_key(p):
    """Hashable key of everything the members of one group must share
    (architecture with its widths, dataset, every constant of the training
    loop: the values of ``_MATCH_KEYS``), or None when the run is not
    groupable: baseline models, real-data runs, ``func_appl_X``, resumes,
    plot-only runs, or any option outside the grouped path."""
    ds = p.get("dataset", "BlackScholes")
    if (p.get("other_model") is not None
            or (ds not in SYNTHETIC_DATASETS and "combined" not in ds)
            or p.get("func_appl_X")
            or p.get("resume_training")
            or p.get("plot_only")):
        return None
    known = {k for k, _ in _MATCH_KEYS} | set(_VARY_KEYS) | set(_INERT_KEYS)
    if set(p) - known:
        return None
    return tuple(_norm_val(k, p.get(k, d)) for k, d in _MATCH_KEYS)


# position of training_size in the group_key tuple
_TS_KEY_INDEX = [k for k, _ in _MATCH_KEYS].index("training_size")


def plan_compile_sharing(params_list, groups):
    """For groups that differ ONLY in training_size (and have equal member
    counts), ``{group_index: padded_batch_count}``, the largest batch count
    among them (the JAX package shares one compiled epoch program between
    them; here the padding batches are skipped, exact no-ops). Groups with
    an implicit (None) training_size are left out."""
    from collections import defaultdict
    sup = defaultdict(list)
    for gi, g in enumerate(groups):
        p = params_list[g[0]]
        ts = p.get("training_size")
        if not ts:
            continue
        k = group_key(p)
        k_nots = k[:_TS_KEY_INDEX] + k[_TS_KEY_INDEX + 1:] + (len(g),)
        sup[k_nots].append((gi, int(ts) // int(p.get("batch_size", 100))))
    pads = {}
    for lst in sup.values():
        m = max(nb for _, nb in lst)
        for gi, _ in lst:
            pads[gi] = m
    return pads


def plan_groups(params_list, min_group=2):
    """``(groups, singles)``: groups of >= ``min_group`` entries sharing
    :func:`group_key`, the other indices in order (solo runs)."""
    return group_common.plan_groups(params_list, group_key, min_group)


def _member_split(n_paths, test_size, seed, training_size, sub_seed):
    """The solo trainer's split (``trainer.train_val_split``, on the raw
    seed) and subsample (``RandomState(sub_seed)``, the repeat_seed-offset
    stream)."""
    train_idx, val_idx = train_val_split(n_paths, test_size, seed)
    if training_size is not None and training_size < len(train_idx):
        train_idx = np.random.RandomState(sub_seed).choice(
            train_idx, training_size, replace=False)
    return train_idx, val_idx


def make_group_step_fns(models, optimizers, times, dts, next_cond_exp=None,
                        use_kernels=False, mask_mode="prng"):
    """The group's step functions over a device-resident dataset, member e
    on its own index streams:

    - ``train_epoch(paths, obs, idx_mats, weight, generators)``:
      ``idx_mats [E, n_batches, B]`` rows of ``paths/obs``, one step a
      batch for all members; returns the losses ``[n_batches, E]``;
    - ``train_step(paths, obs, idxs, weight, generators)``: one step, each
      member on its rows ``idxs[e]``; returns ``[E]``;
    - ``eval_all(paths, obs, val_idxs, weight, do_msd)``: each member's
      validation loss on its rows (K3 with ``use_kernels``, else eager)
      and, with ``do_msd``, the oracle's mean squared difference (0
      without); ``([E], [E])``;
    - ``train_epochs(paths, obs, idx_mats_c, weights, generators_c,
      val_idxs, do_msd)``: C epochs and their evaluations and per-member
      snapshots queued before the host reads anything (the solo
      ``train_epochs``): ``(last losses [C, E], evals [C, E], msds [C, E],
      snapshots [C][E])``.
    """
    solo = [make_step_fns(m, o, times, dts, next_cond_exp,
                          use_kernels=use_kernels, mask_mode=mask_mode)
            for m, o in zip(models, optimizers)]
    step = group_common.make_group_step(models, optimizers, use_kernels,
                                        mask_mode)
    E = len(models)
    everyone = list(range(E))

    def train_step(paths, obs, idxs, weight, generators):
        batches = [gather_dense_batch(paths, obs, idx, times, dts)
                   for idx in idxs]
        return step(batches, weight, generators, everyone)

    def train_epoch(paths, obs, idx_mats, weight, generators):
        return torch.stack([
            train_step(paths, obs, idx_mats[:, j], weight, generators)
            for j in range(idx_mats.shape[1])])

    no_msd = torch.zeros((), dtype=torch.float32)

    def eval_all(paths, obs, val_idxs, weight, do_msd):
        ev, ms = [], []
        for e in range(E):
            ev.append(solo[e]["eval_loss"](paths, obs, val_idxs[e], weight))
            ms.append(solo[e]["eval_msd"](paths, obs, val_idxs[e])
                      if do_msd and "eval_msd" in solo[e]
                      else no_msd.to(paths.device))
        return torch.stack(ev), torch.stack(ms)

    def train_epochs(paths, obs, idx_mats_c, weights, generators_c,
                     val_idxs, do_msd):
        tl, ev, ms, snaps = [], [], [], []
        for idx_mats, weight, gens in zip(idx_mats_c, weights,
                                          generators_c):
            tl.append(train_epoch(paths, obs, idx_mats, weight, gens)[-1])
            e_, m_ = eval_all(paths, obs, val_idxs, weight, do_msd)
            ev.append(e_)
            ms.append(m_)
            snaps.append([checkpoints.snapshot(m, o)
                          for m, o in zip(models, optimizers)])
        return torch.stack(tl), torch.stack(ev), torch.stack(ms), snaps

    return {"train_step": train_step, "train_epoch": train_epoch,
            "eval_all": eval_all, "train_epochs": train_epochs}


def train_group(group_params, verbose=True, pad_batches_to=None,
                mesh=None):
    """Train one group end to end with the solo trainer's artifacts.

    :param group_params: reconciled param dicts (model_id assigned, the
        same :func:`group_key`); seeds may differ per member.
    :param pad_batches_to: the epoch padded to this many batches (the
        sweep runner's ``plan_compile_sharing``). No member trains on a
        padding batch, so the port skips them: no launch, no optimizer
        step, an exact no-op (the JAX package runs them to share one
        compiled program and suppresses their updates).
    :param mesh: a ``parallel.sharding.Mesh`` whose ranks split the members
        (every rank calls with the same arguments); a member's numbers are
        those it has without one
    :return: list of 0s (reference convention), one per member
    """
    E = len(group_params)
    shard = group_common.MemberShard(E, mesh)
    p0 = group_params[0]
    device = torch.device(p0.get("device", "cuda"))
    saved_models_path = (p0.get("saved_models_path")
                         or path_cfg.saved_models_path)
    base_data_path = p0.get("base_data_path")
    dataset = p0.get("dataset", "BlackScholes")
    dataset_id = int(du._get_time_id(dataset, p0.get("dataset_id"),
                                     base_data_path))
    metadata = du.load_metadata(dataset, dataset_id, base_data_path)
    delta_t = metadata["dt"]
    input_size = metadata["dimension"]
    epochs = int(p0.get("epochs", 100))
    batch_size = int(p0.get("batch_size", 100))
    evaluate = bool(p0.get("evaluate"))

    cfg = njode.NJODEConfig(
        input_size=input_size, hidden_size=int(p0.get("hidden_size", 10)),
        output_size=input_size,
        ode_nn=group_common.norm_nn(p0.get("ode_nn")),
        readout_nn=group_common.norm_nn(p0.get("readout_nn")),
        enc_nn=group_common.norm_nn(p0.get("enc_nn")),
        use_rnn=bool(p0.get("use_rnn", False)),
        bias=bool(p0.get("bias", True)),
        dropout_rate=float(p0.get("dropout_rate", 0.1)),
        solver=str(p0.get("solver", "euler")),
        which_loss=str(p0.get("which_loss", "standard")),
        residual_enc_dec=bool(p0.get("residual_enc_dec", True)),
        input_current_t=bool(p0.get("input_current_t", False)),
        masked=bool(p0.get("masked", False)),
        compute_dtype=str(p0.get("compute_dtype", "float32")))
    next_cond_exp = sde.make_model(metadata["model_name"],
                                   metadata).next_cond_exp

    # the whole dataset on the device once; each member's split by its seed
    data = du.load_dataset(dataset, dataset_id, base_data_path)
    ds_all = du.PathDataset(data=data)
    paths_np, obs_np = ds_all.dense_arrays(None)
    d_paths = torch.as_tensor(paths_np, device=device)
    d_obs = torch.as_tensor(obs_np, device=device)
    K = paths_np.shape[2] - 1
    times = torch.as_tensor((np.arange(1, K + 1) * delta_t)
                            .astype(np.float32), device=device)
    dts = torch.full((K,), delta_t, dtype=torch.float32, device=device)

    seeds = [int(p.get("seed", 398)) for p in group_params]
    rseeds = [s + 7_654_321 * int(p.get("repeat_seed", 0) or 0)
              for p, s in zip(group_params, seeds)]
    splits = [_member_split(metadata["nb_paths"],
                            float(p.get("test_size", 0.2)), s,
                            p.get("training_size"), r)
              for p, s, r in zip(group_params, seeds, rseeds)]
    n_train = len(splits[0][0])
    if any(len(t) != n_train for t, _ in splits):
        raise ValueError("group members must share training_size "
                         "(group_key enforces this)")
    n_full = (n_train // batch_size) * batch_size
    n_batches = n_full // batch_size
    # this rank's slots (all members without a mesh)
    l_rseeds, l_splits = shard.take(rseeds), shard.take(splits)
    EL = len(l_rseeds)
    val_idxs = [torch.as_tensor(v, device=device) for _, v in l_splits]

    # each member's optimal eval loss on its validation split (as solo)
    opt_losses = []
    for _, vidx in splits:
        vb = to_torch(recompute_n_obs(batch_from_paths(
            ds_all.stock_paths[vidx], ds_all.observed_dates[vidx],
            delta_t)), device)
        opt_losses.append(float(oracle.optimal_loss(next_cond_exp, vb,
                                                     weight=0.5)))

    lr = float(p0.get("learning_rate", 1e-3))
    models, optimizers = [], []
    for r in l_rseeds:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(r)
            model = njode.NJODE(cfg)
        model.to(device)
        models.append(model)
        optimizers.append(make_optimizer(model.parameters(), lr))
    from njode_tpu_torch.ops import fused_scan
    use_kernels = p0.get("use_pallas")
    if use_kernels is None:
        use_kernels = fused_scan._is_cuda(device) and fused_scan.supported(
            cfg)
    fns = make_group_step_fns(models, optimizers, times, dts, next_cond_exp,
                              use_kernels=bool(use_kernels),
                              mask_mode=str(p0.get("pallas_mask_mode",
                                                   "prng")))
    verbose = verbose and shard.writer
    if verbose and (pad_batches_to or 0) > n_batches:
        print(f"group: {pad_batches_to - n_batches} padding batches an "
              "epoch skipped (exact no-ops)")

    metr_columns = METR_COLUMNS + (["evaluation_mean_diff"] if evaluate
                                   else [])
    arts = group_common.MemberArtifacts(group_params, saved_models_path,
                                        metr_columns, shard.writer)
    save_every = int(p0.get("save_every", 1))
    cur_weight = float(p0.get("weight", 0.5))
    w_decay = float(p0.get("weight_decay", 1.0))
    best_eval = np.full(E, np.inf)

    if verbose:
        print(f"group: {E} members, ids="
              f"{[p['model_id'] for p in group_params]}, dataset={dataset}, "
              f"arch={cfg.ode_nn}, training_size={n_train}, "
              f"training loss: {'member-axis kernels' if use_kernels else 'eager forward'}")

    def _perm(e, ep):
        return np.random.RandomState(
            (l_rseeds[e] * 100_003 + ep) % 2 ** 32).permutation(n_train)

    def _generators(ep):
        return [torch.Generator(device=device).manual_seed(
            ((r + 1) * 100_003 + ep) % 2 ** 63) for r in l_rseeds]

    def _epoch_rows(ep):
        """``[EL, n_batches, B]`` global rows of each slot's batches (its
        member's shuffle over its training positions) and each slot's tail
        rows."""
        mats = np.zeros((EL, n_batches, batch_size), np.int64)
        tails = []
        for e, (tr, _) in enumerate(l_splits):
            rows = np.asarray(tr)[_perm(e, ep)]
            mats[e, :n_batches] = rows[:n_full].reshape(n_batches,
                                                        batch_size)
            tails.append(rows[n_full:])
        return torch.as_tensor(mats, device=device), tails

    def _bookkeep(ep, last_losses, ev, ms, ttime, etime, weight, states):
        """Each member's metric row and checkpoints, the solo trainer's
        cadence (``last_losses``, ``ev``, ``ms``: every member's;
        ``states()``: this rank's slots' (model, optimizer) states, brought
        to the writer once and only when a slot is written)."""
        for i in range(E):
            row = [ep, ttime, etime, float(last_losses[i]), float(ev[i]),
                   opt_losses[i]]
            if evaluate:
                row.append(float(ms[i]))
            arts.append(i, row)
        if verbose:
            print(f"epoch {ep}, weight={weight:.5f}, eval-loss="
                  f"{np.array2string(np.asarray(ev), precision=5)}")
        saving = [i for i in range(E)
                  if ep % save_every == 0 or ev[i] < best_eval[i]]
        host = shard.gather_states(states()) if saving else None
        for i in saving:
            arts.flush(i)
            if host is not None:
                arts.save(i, "last_checkpoint", host[i], ep, weight)
            if ev[i] < best_eval[i]:
                if host is not None:
                    arts.save(i, "best_checkpoint", host[i], ep, weight)
                best_eval[i] = ev[i]

    epoch_chunk = int(p0.get("epoch_chunk", 0) or 0)
    if epoch_chunk > 1:
        state_bytes = 3 * E * sum(p.numel() * p.element_size()
                                  for p in models[0].parameters())
        max_chunk = int(p0.get("epoch_chunk_hist_bytes", HIST_BUDGET)) // \
            max(state_bytes, 1)
        if max_chunk < 2:
            print("epoch_chunk disabled: the group's state exceeds the "
                  "history budget; using per-epoch dispatch")
            epoch_chunk = 0
        elif epoch_chunk > max_chunk:
            print(f"epoch_chunk: capping {epoch_chunk} -> {max_chunk}")
            epoch_chunk = max_chunk
    use_chunked = epoch_chunk > 1 and n_full == n_train
    if epoch_chunk > 1 and not use_chunked:
        print("epoch_chunk disabled (ragged last batch); using per-epoch "
              "dispatch")

    epoch = 1
    while epoch <= epochs and use_chunked:
        n_ep = min(epoch_chunk, epochs - epoch + 1)
        t0 = time.time()
        ws, w = [], cur_weight
        for _ in range(n_ep):
            ws.append(w)
            w = njode.weight_decay_step(w, w_decay)
        tl, ev, ms, snaps = fns["train_epochs"](
            d_paths, d_obs, [_epoch_rows(epoch + j)[0] for j in range(n_ep)],
            ws, [_generators(epoch + j) for j in range(n_ep)], val_idxs,
            evaluate)
        tl, ev, ms = (shard.gather(t, 1).cpu().numpy() for t in (tl, ev, ms))
        per_ep = (time.time() - t0) / (n_ep * E)
        for j in range(n_ep):
            _bookkeep(epoch + j, tl[j], ev[j], ms[j], per_ep, 0.0, ws[j],
                      lambda j=j: snaps[j])
        epoch += n_ep
        cur_weight = w

    while epoch <= epochs:
        t0 = time.time()
        mats, tails = _epoch_rows(epoch)
        gens = _generators(epoch)
        losses = []
        if n_batches:
            losses.append(fns["train_epoch"](d_paths, d_obs, mats,
                                             cur_weight, gens))
        if n_full < n_train:
            losses.append(fns["train_step"](
                d_paths, d_obs, [torch.as_tensor(t, device=device)
                                 for t in tails], cur_weight, gens)[None])
        last = shard.gather(torch.cat(losses)[-1]).cpu().numpy()
        train_time = (time.time() - t0) / E

        t0 = time.time()
        ev, ms = fns["eval_all"](d_paths, d_obs, val_idxs, cur_weight,
                                 evaluate)
        ev, ms = shard.gather(ev).cpu().numpy(), shard.gather(ms).cpu().numpy()
        eval_time = (time.time() - t0) / E
        _bookkeep(epoch, last, ev, ms, train_time, eval_time, cur_weight,
                  lambda: [(m.state_dict(), o.state_dict())
                           for m, o in zip(models, optimizers)])
        epoch += 1
        cur_weight = njode.weight_decay_step(cur_weight, w_decay)

    arts.flush_pending()
    return [0] * E
