"""Hyperparameter-sweep orchestration, the port's copy of
``njode_tpu/training/sweeps.py``.

- :func:`train_switcher`: dispatch on ``dataset``: the synthetic names and
  ``combined*`` go to the synthetic trainer, ``'climate'`` to the climate
  trainer, ``'physionet'`` to the PhysioNet trainer;
- :func:`get_parameter_array`: the cartesian grid of a dict of lists, in
  the order of sklearn's ``ParameterGrid`` (sklearn is not needed);
- :func:`parallel_training`: ids assigned against ``model_overview.csv``
  before any run starts (resume by ``model_ids``, or by ``first_id`` for
  ids already registered; ``overwrite_params`` rewrites the saved
  description), then the runs one after another (``nb_jobs > 1``: a
  joblib pool), each run's exception becoming its result; with
  ``vmap_groups`` the groupable entries train as grouped ensembles.

The runs go one after another by default. With ``vmap_groups=True`` the
entries that differ only in their seeds and ids (repeats, folds) train as
one ensemble each, K1 and K2 launched once a step for all members
(``group_sweep``, ``physionet_group``, ``climate_group``); a grid of small
nets leaves most of the card idle run by run. The device mesh of the JAX
sweep's groups (``group_mesh``) is not ported (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import itertools
import json
import traceback

from njode_tpu_torch.training import registry
from njode_tpu_torch.utils.notifications import SBM, SEND
from njode_tpu_torch.utils.paths import makedirs, saved_models_path as \
    default_saved_models_path

DEBUG = False
error_chat_id = None

SYNTHETIC_DATASETS = ("BlackScholes", "Heston", "OrnsteinUhlenbeck",
                      "HestonWOFeller", "sine_BlackScholes", "sine_Heston",
                      "sine_OrnsteinUhlenbeck")
# live runtime objects: passed to the run, kept out of the registry JSON
# (a record list would come back as its str() form)
_LIVE_KEYS = ("records", "mesh")


def train_switcher(**params):
    """Dispatch a run to the right trainer by its 'dataset' param."""
    if "dataset" not in params:
        raise KeyError('the "dataset" needs to be specified')
    ds = params["dataset"]
    if ds in SYNTHETIC_DATASETS or "combined" in ds:
        from njode_tpu_torch.training import trainer
        return trainer.train(**params)
    if ds == "climate":
        from njode_tpu_torch.training import climate_trainer
        return climate_trainer.train(**params)
    if ds == "physionet":
        from njode_tpu_torch.training import physionet_trainer
        return physionet_trainer.train(**params)
    raise ValueError(f'the specified "dataset" {ds} is not supported')


def get_parameter_array(param_dict):
    """Cartesian expansion of a dict of lists into a list of param dicts:
    the keys sorted, the last key varying fastest (sklearn's
    ``ParameterGrid`` order)."""
    keys = sorted(param_dict)
    return [dict(zip(keys, v))
            for v in itertools.product(*(param_dict[k] for k in keys))]


def reject_grouping(vmap_groups=False, group_mesh=None):
    """Raise for the device mesh of the JAX sweep's groups, not ported yet
    (grouping itself, ``vmap_groups``, is)."""
    if group_mesh is not None:
        raise NotImplementedError(
            "group_mesh is not ported yet (ROADMAP.md Queue 1 item 7: data "
            "parallelism)")


def _saved_params(desc, model_id, overwrite_params):
    """The run's params from its registered description, marked to resume;
    with ``overwrite_params`` also the rewritten description."""
    params_dict = json.loads(desc)
    params_dict["resume_training"] = True
    params_dict["model_id"] = model_id
    if overwrite_params:
        params_dict.update(overwrite_params)
        desc = json.dumps(params_dict, sort_keys=True, default=str)
    return params_dict, desc


def parallel_training(params=None, model_ids=None, nb_jobs=1, first_id=None,
                      saved_models_path=None, overwrite_params=None,
                      vmap_groups=False, group_mesh=None):
    """Run a sweep, reconciling model ids against the overview registry.

    - ``params`` + ``first_id``: params[i] gets id ``first_id + i`` (or the
      next free ids); ids already registered resume with their *saved*
      description (params[i] is then ignored but for ``overwrite_params``
      and its live keys 'records' and 'mesh');
    - ``model_ids``: resume exactly those registered ids;
    - ids are assigned before any run starts; every run gets
      ``parallel=True`` (it does not touch the registry itself) and the
      sweep's ``saved_models_path`` unless it names its own.
    - ``vmap_groups``: the synthetic groups of ``group_sweep.plan_groups``
      first (each with its ``plan_compile_sharing`` padding), then the
      PhysioNet groups, then the climate groups among the leftovers, then
      the remaining entries solo; a group that raises falls back to its
      members solo, as a sweep without grouping would run them;
    - ``group_mesh`` raises ``NotImplementedError``.

    :return: list of per-run return values (0 on success, the exception of
        a run that raised), or None if the sweep itself failed
    """
    reject_grouping(vmap_groups, group_mesh)
    if params is not None and "saved_models_path" in params[0]:
        saved_models_path = params[0]["saved_models_path"]
    saved_models_path = saved_models_path or default_saved_models_path
    makedirs(saved_models_path)
    rows = registry.load_overview(saved_models_path)
    ids = [r[0] for r in rows]
    max_id = max(ids) if ids else 0

    if model_ids is None and params is None:
        return 0
    if model_ids is None:
        model_id = (max_id + 1) if first_id is None else first_id
        for i, param in enumerate(params):
            live = {k: param[k] for k in _LIVE_KEYS if k in param}
            if model_id in ids:
                row = rows[ids.index(model_id)]
                params_dict, row[1] = _saved_params(row[1], model_id,
                                                    overwrite_params)
                if overwrite_params:
                    registry.write_overview(saved_models_path, rows)
            else:
                desc = json.dumps(
                    {k: v for k, v in param.items() if k not in _LIVE_KEYS},
                    sort_keys=True, default=str)
                rows.append([model_id, desc])
                ids.append(model_id)
                registry.write_overview(saved_models_path, rows)
                params_dict = json.loads(desc)
                params_dict["resume_training"] = False
                params_dict["model_id"] = model_id
            params[i] = dict(params_dict, **live)
            model_id += 1
    else:
        params = []
        for model_id in model_ids:
            if model_id not in ids:
                print(f"model_id={model_id} does not exist yet -> skip")
                continue
            row = rows[ids.index(model_id)]
            params_dict, row[1] = _saved_params(row[1], model_id,
                                                overwrite_params)
            if overwrite_params:
                registry.write_overview(saved_models_path, rows)
            params.append(params_dict)

    for param in params:
        param["parallel"] = True
        param.setdefault("saved_models_path", saved_models_path)

    if SEND:
        SBM.send_notification(
            text=f"start parallel training - \nparams:\n\n{params}")

    def _solo(p):
        # per-run failure isolation: one failing config does not stop the
        # sweep; its exception becomes that run's result. Under DEBUG the
        # exception propagates unchanged.
        if DEBUG:
            return train_switcher(**p)
        try:
            return train_switcher(**p)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            print(f"run id={p.get('model_id')} failed ({type(e).__name__}: "
                  f"{e}); continuing with the remaining runs", flush=True)
            return e

    def _grouped_or_solo(idx, run_group):
        # a group that fails (e.g. more device memory than the members
        # alone take) falls back to its members solo
        try:
            return run_group()
        except Exception as e:  # noqa: BLE001
            if DEBUG:
                raise
            traceback.print_exc()
            ids = [params[i].get("model_id") for i in idx]
            print(f"group for ids {ids} failed ({e}); falling back to solo "
                  "training", flush=True)
            return [_solo(params[i]) for i in idx]

    def _run_grouped():
        from njode_tpu_torch.training import climate_group, group_sweep, \
            physionet_group
        groups, singles = group_sweep.plan_groups(params)
        pads = group_sweep.plan_compile_sharing(params, groups)
        results = [None] * len(params)
        for gi, g in enumerate(groups):
            res = _grouped_or_solo(g, lambda g=g, gi=gi: group_sweep.
                                   train_group([params[i] for i in g],
                                               pad_batches_to=pads.get(gi)))
            for i, r in zip(g, res):
                results[i] = r
        left = list(singles)
        for planner in (physionet_group, climate_group):
            pgroups, rest = planner.plan_groups([params[i] for i in left])
            for g in pgroups:
                real = [left[i] for i in g]
                res = _grouped_or_solo(real, lambda real=real, planner=planner:
                                       planner.train_group(
                                           [params[i] for i in real]))
                for i, r in zip(real, res):
                    results[i] = r
            left = [left[i] for i in rest]
        for i in left:
            results[i] = _solo(params[i])
        return results

    def _run_all():
        if vmap_groups:
            return _run_grouped()
        if nb_jobs <= 1:
            return [_solo(p) for p in params]
        from joblib import Parallel, delayed
        return Parallel(n_jobs=nb_jobs)(delayed(_solo)(p) for p in params)

    if DEBUG:
        results = _run_all()
    else:
        try:
            results = _run_all()
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            if SEND:
                SBM.send_notification(
                    text=f"error in parallel training - \nerror:\n\n{e}",
                    chat_id=error_chat_id)
            else:
                print(f"error:\n\n{e}")
            return None
    if SEND:
        SBM.send_notification(
            text=f"finished parallel training - \nparams:\n\n{params}")
    return results
