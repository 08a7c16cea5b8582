"""The port's trainers and grouped sweep under a 2-way mesh against the JAX
package's under ``sharding.make_mesh(2)`` (the virtual CPU devices) and
against the port's own runs without a mesh.

One spawn of two gloo ranks (``torch_parallel_ranks.trainer_runs``) trains
one epoch each of the synthetic NJODE trainer (at dropout 0, and at 0.1 in
'input' mode), the synthetic GRU-ODE-Bayes trainer, the climate trainer
(NJODE and GRU-ODE-Bayes, pre-stacked, the validation and test batches
padded to an even count) and the PhysioNet trainer, through the kernels'
plain versions, and the synthetic NJODE and GOB trainers at dropout 0.1
through the eager forward (every rank draws the global masks and keeps
its rows), then a grouped sweep of three repeats over the two ranks (one
ghost member). The JAX trainers start from the port's initial weights (their
``init_params`` patched) at dropout 0. Held: the metric rows at the loss
tolerance (rtol 1e-5, atol 1e-6), the parameters of both ranks equal bit
for bit, and the grouped members' rows and checkpoints bit for bit the
1-rank group's."""

import dataclasses
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

import torch_parallel_ranks
import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.models import njode as jnjode
from njode_tpu.parallel import sharding as jsharding
from njode_tpu_torch.data import climate as tcdu
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.data import physionet as tpdu
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.parallel import sharding
from njode_tpu_torch.training import registry
from njode_tpu_torch.training.jax_compat import \
    gob_jax_params_from_state_dict, jax_params_from_state_dict
from njode_tpu_torch.utils.csv_frame import read_frame, to_float

pytestmark = pytest.mark.subprocess

NN = (((16, "tanh"),))
SEED = 398
NET = dict(hidden_size=6, ode_nn=NN, readout_nn=NN, enc_nn=NN)
GOB_OPTS = {"GRU_ODE_Bayes-impute": True, "GRU_ODE_Bayes-logvar": True,
            "GRU_ODE_Bayes-mixing": 1e-4}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel_trainers")
    data = str(base / "data")
    hp = dict(tdatasets.hyperparam_default, nb_paths=60, nb_steps=10)
    tdatasets.create_dataset("BlackScholes", hp, seed=0, base_path=data,
                             device="cpu")
    clim = str(base / "climate")
    os.makedirs(clim)
    tcdu.make_synthetic_climate_csv(
        os.path.join(clim, "small_chunked_sporadic.csv"), n_series=16,
        n_vars=3, T=5.0, obs_perc=0.1, seed=5)
    tcdu.make_fold_indices(clim, n_series=16, n_folds=1, seed=2)
    recs = tpdu.make_synthetic_records(20, n_vars=4, quantization=2.0,
                                       obs_perc=0.25, seed=11)
    synth = dict(epochs=1, batch_size=8, dataset="BlackScholes",
                 base_data_path=data, evaluate=True, use_pallas=True,
                 device="cpu", dropout_rate=0.0, **NET)
    jobs = {
        "synthetic": ("njode_tpu_torch.training.trainer", synth),
        "synthetic_drop": ("njode_tpu_torch.training.trainer", dict(
            synth, dropout_rate=0.1, pallas_mask_mode="input")),
        "synthetic_eager": ("njode_tpu_torch.training.trainer", dict(
            synth, dropout_rate=0.1, use_pallas=False)),
        "gob": ("njode_tpu_torch.training.trainer", dict(
            synth, other_model="GRU_ODE_Bayes", **GOB_OPTS)),
        "gob_eager": ("njode_tpu_torch.training.trainer", dict(
            synth, other_model="GRU_ODE_Bayes", dropout_rate=0.1,
            use_pallas=False, **GOB_OPTS)),
        "climate": ("njode_tpu_torch.training.climate_trainer", dict(
            epochs=1, batch_size=6, climate_dir=clim, T=5.0, T_val=3.0,
            use_pallas=True, device="cpu", dropout_rate=0.0, **NET)),
        "climate_gob": ("njode_tpu_torch.training.climate_trainer", dict(
            epochs=1, batch_size=6, climate_dir=clim, T=5.0, T_val=3.0,
            use_pallas=True, device="cpu", dropout_rate=0.1,
            pallas_mask_mode="input", other_model="GRU_ODE_Bayes",
            **dict(NET, ode_nn=None, readout_nn=None, enc_nn=None),
            **{"GRU_ODE_Bayes-p_hidden": 5,
               "GRU_ODE_Bayes-prep_hidden": 3})),
        "physionet": ("njode_tpu_torch.training.physionet_trainer", dict(
            epochs=1, batch_size=4, quantization=2.0, n_samples=20,
            records=recs, use_pallas=True, device="cpu", dropout_rate=0.0,
            **dict(NET, hidden_size=8))),
    }
    group = [dict(synth, dropout_rate=0.1, repeat_seed=r) for r in range(3)]

    def place(root):
        js = {t: (m, dict(kw, saved_models_path=os.path.join(root, t)))
              for t, (m, kw) in jobs.items()}
        return js, (group, dict(saved_models_path=os.path.join(root,
                                                               "group")))

    mesh_jobs, mesh_group = place(str(base / "mesh"))
    outs = sharding.spawn(torch_parallel_ranks.trainer_runs, 2,
                          args=(mesh_jobs, mesh_group), wait=900)
    return dict(base=str(base), jobs=jobs, place=place, outs=outs,
                mesh_jobs=mesh_jobs, mesh_group=mesh_group)


def _rows(path):
    cols, rows = read_frame(path)
    return {c: [to_float(r[i]) for r in rows] for i, c in enumerate(cols)}


def _metric_file(root, mid=1):
    return os.path.join(root, f"id-{mid}", f"metric_id-{mid}.csv")


def _assert_rows_close(got, ref, cols):
    for c in cols:
        np.testing.assert_allclose(got[c], ref[c], err_msg=c, **H.LOSS_TOL)


LOSS_COLS = {"synthetic": ("train_loss", "eval_loss", "evaluation_mean_diff"),
             "synthetic_drop": ("train_loss", "eval_loss",
                                "evaluation_mean_diff"),
             "synthetic_eager": ("train_loss", "eval_loss",
                                 "evaluation_mean_diff"),
             "gob": ("train_loss", "eval_loss", "evaluation_mean_diff"),
             "gob_eager": ("train_loss", "eval_loss",
                           "evaluation_mean_diff"),
             "climate": ("train_loss", "eval_loss", "eval_metric",
                         "test_loss", "test_metric"),
             "climate_gob": ("train_loss", "eval_loss", "eval_metric",
                             "test_loss", "test_metric"),
             "physionet": ("train_loss", "eval_loss", "eval_metric",
                           "eval_metric_2")}


@pytest.mark.parametrize("tag", list(LOSS_COLS))
def test_two_ranks_match_the_run_without_a_mesh(setup, tag):
    """Every rank returns 0 and ends with rank 0's parameters bit for bit;
    rank 0's metric rows are the port's run without a mesh (the same
    batches, at dropout 0.1 the same 'input' masks, drawn globally)."""
    from importlib import import_module

    for out in setup["outs"]:
        assert out[tag]["result"] == 0 and out[tag]["same"]
    module, kw = setup["jobs"][tag]
    solo = os.path.join(setup["base"], "solo", tag)
    assert import_module(module).train(saved_models_path=solo, **kw) == 0
    got = _rows(_metric_file(setup["mesh_jobs"][tag][1]
                             ["saved_models_path"]))
    _assert_rows_close(got, _rows(_metric_file(solo)), LOSS_COLS[tag])
    assert setup["outs"][1][tag]["rows"] is None   # rank 1 wrote nothing


def _port_init(kind, seed, monkeypatch):
    """Patch the JAX package's ``init_params`` to return the port's
    initial weights (``NJODE`` under ``torch.manual_seed(seed)``, ``GOB``
    with a generator seeded ``seed``), as JAX pytrees."""
    def njode_init(key, jcfg):
        tcfg = tnjode.NJODEConfig(**dataclasses.asdict(jcfg))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sd = tnjode.NJODE(tcfg).state_dict()
        return jax_params_from_state_dict(sd)

    def gob_init(key, jcfg):
        tcfg = tgob.GOBConfig(**dataclasses.asdict(jcfg))
        sd = tgob.GOB(tcfg, generator=torch.Generator().manual_seed(
            seed)).state_dict()
        return gob_jax_params_from_state_dict(sd)

    if kind == "gob":
        monkeypatch.setattr(jgob, "init_params", gob_init)
    else:
        monkeypatch.setattr(jnjode, "init_params", njode_init)


@pytest.mark.parametrize("tag", ["synthetic", "gob", "climate",
                                 "physionet"])
def test_two_ranks_match_the_jax_trainer_under_a_mesh(setup, tag,
                                                      monkeypatch):
    """The JAX trainer under ``make_mesh(2)``, from the same initial
    weights at dropout 0, writes the metric rows the port's two ranks
    write."""
    from importlib import import_module

    _port_init(tag, SEED, monkeypatch)
    module, kw = setup["jobs"][tag]
    kw = {k: v for k, v in kw.items() if k not in ("use_pallas", "device")}
    jroot = os.path.join(setup["base"], "jax", tag)
    if tag in ("synthetic", "gob"):
        kw["plot"] = False
    assert import_module(module.replace("njode_tpu_torch", "njode_tpu")
                         ).train(saved_models_path=jroot,
                                 mesh=jsharding.make_mesh(2), **kw) == 0
    got = _rows(_metric_file(setup["mesh_jobs"][tag][1]
                             ["saved_models_path"]))
    _assert_rows_close(got, _rows(_metric_file(jroot)), LOSS_COLS[tag])


def _checkpoint(root, mid, slot):
    ck = torch.load(os.path.join(root, f"id-{mid}", slot, "checkpt.tar"),
                    weights_only=True)
    return ck["model_state_dict"], ck["optimizer_state_dict"]


def test_group_over_two_ranks_equals_one_rank_group(setup):
    """Three repeats over two ranks (rank 1 trains member 2 and a ghost
    copy of it): every result 0 on rank 0, rank 1 reports the group's
    results too; each member's metric row (but the times) and both
    checkpoints' tensors equal the 1-rank group's bit for bit; one
    registry row a member."""
    from njode_tpu_torch.training import sweeps

    params, kw = setup["mesh_group"]
    assert [o["group"] for o in setup["outs"]] == [[0, 0, 0]] * 2
    one = os.path.join(setup["base"], "group_one")
    assert sweeps.parallel_training(params=[dict(p) for p in params],
                                    vmap_groups=True,
                                    saved_models_path=one) == [0, 0, 0]
    two = kw["saved_models_path"]
    assert [r[0] for r in registry.load_overview(two)] == [1, 2, 3]
    for mid in (1, 2, 3):
        a, b = _rows(_metric_file(two, mid)), _rows(_metric_file(one, mid))
        for c in a:
            if c not in ("train_time", "eval_time"):
                assert a[c] == b[c], (mid, c)
        for slot in ("last_checkpoint", "best_checkpoint"):
            (ma, oa), (mb, ob) = (_checkpoint(r, mid, slot)
                                  for r in (two, one))
            assert all(torch.equal(ma[k], mb[k]) for k in mb)
            sa = [t for st in oa["state"].values() for t in st.values()]
            sb = [t for st in ob["state"].values() for t in st.values()]
            assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_indivisible_batch_size_raises(setup):
    """A batch size the mesh size does not divide is refused before
    anything runs (the JAX trainers' check)."""
    from njode_tpu_torch.training import trainer

    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        trainer.train(mesh=sharding.Mesh(2, 0), batch_size=7, device="cpu")
