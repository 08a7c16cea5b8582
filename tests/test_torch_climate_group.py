"""The port's grouped climate folds (njode_tpu_torch/training/
climate_group.py): the planner against the JAX package's, and the folds of
one architecture as a group over the bank of all series against the same
entries run solo through the sweep runner (metric rows and checkpoints bit
for bit, on the eager route and on the kernels' route, whose plain
versions run on the CPU); the folds differ in train size, so the member
with fewer batches sits the last step out, its weights, Adam moments and
step count untouched."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

from njode_tpu.training import climate_group as jcg
from njode_tpu_torch.data import climate as tcdu
from njode_tpu_torch.training import climate_group as tcg
from njode_tpu_torch.training import sweeps as tsweeps

from test_torch_group_sweep import _ckpt, _rows, _same_runs

NN = ((12, "tanh"),)


@pytest.fixture(scope="module")
def climate_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("climate_group"))
    tcdu.make_synthetic_climate_csv(os.path.join(
        d, "small_chunked_sporadic.csv"), n_series=33, n_vars=3, T=5.0,
        obs_perc=0.1, seed=5)
    tcdu.make_fold_indices(d, n_series=33, n_folds=2, seed=2)
    # fold 1 trains on 7 series fewer: one batch fewer at batch 6
    f1 = os.path.join(d, "small_chunk_fold_idx_1", "train_idx.npy")
    np.save(f1, np.load(f1)[:-7])
    return d


def test_planner_matches_jax():
    base = dict(dataset="climate", epochs=2, batch_size=16, hidden_size=9,
                ode_nn=NN, readout_nn=NN, enc_nn=NN, T=20.0, delta_t=0.1,
                T_val=15.0, max_val_samples=3, climate_dir="/d")
    ps = [dict(base, data_index=f, model_id=f + 1, parallel=True,
               resume_training=False) for f in range(2)]
    ps += [dict(base, other_model="GRU_ODE_Bayes"), dict(base, prestack=False),
           dict(base, epochs=5), dict(base, dataset="physionet")]
    assert tcg.plan_groups(ps) == jcg.plan_groups(ps) == ([[0, 1]],
                                                          [2, 3, 4, 5])


@pytest.mark.parametrize("kw", [dict(use_pallas=True), {}],
                         ids=["kernels", "eager"])
def test_group_matches_sequential(climate_dir, tmp_path, kw, capsys):
    def mk(smp):
        base = dict(dataset="climate", epochs=2, batch_size=6, save_every=1,
                    learning_rate=0.01, hidden_size=9, dropout_rate=0.1,
                    ode_nn=NN, readout_nn=NN, enc_nn=NN,
                    climate_dir=climate_dir, T=5.0, delta_t=0.1, T_val=3.0,
                    max_val_samples=3, device="cpu", saved_models_path=smp,
                    **kw)
        return [dict(base, data_index=0), dict(base, data_index=1),
                dict(base, data_index=0, repeat_seed=1)]

    n_train = [len(np.load(os.path.join(
        climate_dir, f"small_chunk_fold_idx_{f}", "train_idx.npy")))
        for f in (0, 1)]
    assert -(-n_train[0] // 6) != -(-n_train[1] // 6), n_train
    smp_g, smp_s = str(tmp_path / "g") + os.sep, str(tmp_path / "s") + os.sep
    assert tsweeps.parallel_training(params=mk(smp_g), vmap_groups=True) \
        == [0, 0, 0]
    assert "climate group: 3 members" in capsys.readouterr().out
    assert tsweeps.parallel_training(params=mk(smp_s)) == [0, 0, 0]
    _same_runs(smp_g, smp_s, (1, 2, 3))
    assert not np.array_equal(_rows(smp_g, 1)[1], _rows(smp_g, 2)[1])
    # Adam's step count: each member its own fold's batch count an epoch
    for mid, f in ((1, 0), (2, 1)):
        steps = [float(v) for k, v in _ckpt(smp_g, mid, "last_checkpoint")
                 if k.endswith(".step")]
        assert steps and set(steps) == {2.0 * -(-n_train[f] // 6)}


def test_group_mesh_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tcg.train_group([dict(dataset="climate", model_id=1)],
                        mesh=object())
