"""The port's grouped PhysioNet repeats (njode_tpu_torch/training/
physionet_group.py): the planner against the JAX package's, and a group of
repeats over the shared pre-stacked bank against the same entries run solo
through the sweep runner (metric rows and checkpoints bit for bit, on the
eager route and on the kernels' route, whose plain versions run on the
CPU; the GRU jump too), and the group's mesh raising."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

from njode_tpu.training import physionet_group as jpg
from njode_tpu_torch.data import physionet as tpdu
from njode_tpu_torch.training import physionet_group as tpg
from njode_tpu_torch.training import sweeps as tsweeps

from test_torch_group_sweep import _rows, _same_runs

NN = ((8, "tanh"),)


def test_planner_matches_jax():
    base = dict(dataset="physionet", epochs=2, batch_size=8,
                quantization=2.0, n_samples=24, hidden_size=8,
                ode_nn=((12, "tanh"),), readout_nn=((12, "tanh"),),
                enc_nn=((12, "tanh"),))
    ps = [dict(base, repeat_seed=r, model_id=r + 1, parallel=True,
               resume_training=False) for r in range(3)]
    ps += [dict(base, prestack=False), dict(base, ema_decay=0.99),
           dict(base, epochs=5), dict(base, dataset="climate")]
    assert tpg.plan_groups(ps) == jpg.plan_groups(ps) == (
        [[0, 1, 2]], [3, 4, 5, 6])
    assert tpg.plan_groups([dict(base), dict(base, epochs=5)]) == \
        jpg.plan_groups([dict(base), dict(base, epochs=5)]) == ([], [0, 1])
    # the TPU-only keys are inert in the port
    assert tpg.group_key(dict(base, remat=True, use_orbax=True)) == \
        tpg.group_key(base)


@pytest.mark.parametrize("kw", [dict(use_pallas=True), {},
                                dict(use_pallas=True, use_rnn=True)],
                         ids=["kernels", "eager", "kernels_rnn"])
def test_group_matches_sequential(tmp_path, kw, capsys):
    recs = tpdu.make_synthetic_records(20, n_vars=4, quantization=2.0,
                                       obs_perc=0.25, seed=11)

    def mk(smp):
        base = dict(dataset="physionet", epochs=2, batch_size=6,
                    save_every=1, learning_rate=0.01, hidden_size=8,
                    ode_nn=NN, readout_nn=NN, enc_nn=NN, quantization=2.0,
                    n_samples=20, records=recs, device="cpu",
                    saved_models_path=smp, **kw)
        return [dict(base), dict(base, repeat_seed=1), dict(base, seed=7)]

    smp_g, smp_s = str(tmp_path / "g") + os.sep, str(tmp_path / "s") + os.sep
    assert tsweeps.parallel_training(params=mk(smp_g), vmap_groups=True) \
        == [0, 0, 0]
    assert "physionet group: 3 members" in capsys.readouterr().out
    assert tsweeps.parallel_training(params=mk(smp_s)) == [0, 0, 0]
    _same_runs(smp_g, smp_s, (1, 2, 3))
    assert not np.array_equal(_rows(smp_g, 1)[1], _rows(smp_g, 2)[1])


def test_group_mesh_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tpg.train_group([dict(dataset="physionet", model_id=1)],
                        mesh=object())
