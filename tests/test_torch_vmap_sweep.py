"""The port's ensemble training (njode_tpu_torch/training/vmap_sweep.py),
the counterparts of tests/test_vmap_sweep.py: learning progress and
independent members, a one-member ensemble against a hand-written solo
loop bit for bit, a width-heterogeneous ensemble against its small net
alone (the padding exact), and the super-configuration's checks against
the JAX package's."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from njode_tpu.models import njode as jnjode
from njode_tpu.training import vmap_sweep as jvmap
from njode_tpu_torch.models import njode
from njode_tpu_torch.training import vmap_sweep
from njode_tpu_torch.training.steps import gather_dense_batch, \
    make_optimizer

CFG = njode.NJODEConfig(input_size=1, hidden_size=6, output_size=1,
                        ode_nn=((10, "tanh"),), readout_nn=((10, "tanh"),),
                        enc_nn=((10, "tanh"),), dropout_rate=0.0)


def make_data(N=60, steps=12, seed=0):
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0, 0.2, (N, 1, steps + 1))
    obs = (rs.random((N, steps + 1)) < 0.35).astype(np.int64)
    return paths, obs, 1.0 / steps


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "kernels"])
def test_ensemble_trains_and_members_differ(use_kernels):
    paths, obs, dt = make_data()
    out = vmap_sweep.train_ensemble(
        CFG, paths, obs, dt, train_idx=np.arange(40),
        val_idx=np.arange(40, 60), seeds=[1, 2, 3], epochs=8,
        batch_size=20, learning_rate=0.01, device="cpu",
        use_kernels=use_kernels)
    ev = out["eval_losses"]
    assert ev.shape == (8, 3) and out["train_losses"].shape == (8, 3)
    assert np.isfinite(ev).all()
    assert (ev[-1] < ev[0]).all()
    assert not np.allclose(ev[-1][0], ev[-1][1])
    assert len(out["models"]) == 3


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "kernels"])
def test_singleton_ensemble_matches_solo_training(use_kernels):
    """A one-member ensemble reproduces a hand-written solo loop with the
    same streams bit for bit (dropout 0.1: the masks come from the
    member's generator)."""
    from njode_tpu_torch.ops import fused_scan

    cfg = njode.NJODEConfig(1, 6, 1, ((10, "tanh"),), ((10, "tanh"),),
                            ((10, "tanh"),), dropout_rate=0.1)
    paths, obs, dt = make_data(seed=5)
    epochs, bs, seed = 3, 20, 7
    out = vmap_sweep.train_ensemble(
        cfg, paths, obs, dt, train_idx=np.arange(40),
        val_idx=np.arange(40, 60), seeds=[seed], epochs=epochs,
        batch_size=bs, learning_rate=0.01, device="cpu",
        use_kernels=use_kernels)

    K = paths.shape[2] - 1
    times = torch.as_tensor((np.arange(1, K + 1) * dt).astype(np.float32))
    dts = torch.full((K,), dt, dtype=torch.float32)
    d_paths = torch.as_tensor(paths.astype(np.float32))
    d_obs = torch.as_tensor(obs.astype(np.float32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = njode.NJODE(cfg)
    opt = make_optimizer(model.parameters(), 0.01)
    fused = fused_scan.make_fused_loss_fn(cfg) if use_kernels else None
    evs, lasts = [], []
    for epoch in range(1, epochs + 1):
        perm = np.random.RandomState(seed * 100_003 + epoch).permutation(
            np.arange(40)).reshape(-1, bs)
        gen = torch.Generator().manual_seed((seed + 10_000) * 100_003
                                            + epoch)
        for k in range(perm.shape[0]):
            batch = gather_dense_batch(d_paths, d_obs,
                                       torch.as_tensor(perm[k]), times, dts)
            opt.zero_grad(set_to_none=True)
            loss = (fused(model, batch, 0.5, gen, True) if use_kernels else
                    njode.forward(model, batch, weight=0.5, train=True,
                                  generator=gen)[1]) * 1.0
            loss.backward()
            opt.step()
        lasts.append(float(loss.detach()))
        vb = gather_dense_batch(d_paths, d_obs, torch.arange(40, 60), times,
                                dts)
        with torch.no_grad():
            evs.append(float(njode.forward(model, vb, weight=0.5,
                                           train=False)[1]))
    np.testing.assert_array_equal(out["eval_losses"][:, 0],
                                  np.asarray(evs, np.float32))
    np.testing.assert_array_equal(out["train_losses"][:, 0],
                                  np.asarray(lasts, np.float32))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "kernels"])
def test_hetero_ensemble_matches_solo_small_net(use_kernels):
    """A width-heterogeneous ensemble (zero-padded to the super
    architecture): the small member's trajectory is the small net's alone
    (rate 0), the padded entries stay exactly 0, the wide member uses its
    width."""
    paths, obs, dt = make_data(seed=9)

    def cfg_w(w):
        return njode.NJODEConfig(
            input_size=1, hidden_size=6, output_size=1,
            ode_nn=((w, "tanh"),), readout_nn=((w, "tanh"),),
            enc_nn=((w, "tanh"),), dropout_rate=0.0)

    kw = dict(train_idx=np.arange(40), val_idx=np.arange(40, 60), epochs=5,
              batch_size=20, learning_rate=0.01, device="cpu",
              use_kernels=use_kernels)
    out = vmap_sweep.train_ensemble(None, paths, obs, dt, seeds=[3, 4],
                                    cfgs=[cfg_w(6), cfg_w(16)], **kw)
    solo = vmap_sweep.train_ensemble(cfg_w(6), paths, obs, dt, seeds=[3],
                                     **kw)
    np.testing.assert_allclose(out["eval_losses"][:, 0],
                               solo["eval_losses"][:, 0], rtol=1e-6,
                               atol=1e-8)
    small, wide = out["models"]
    w0 = small.ode_f.f[0].weight.detach()          # [16, in]: rows 6.. zero
    assert torch.all(w0[6:] == 0)
    w1 = [m for m in small.ode_f.f if isinstance(m, torch.nn.Linear)][1]
    assert torch.all(w1.weight.detach()[:, 6:] == 0)
    assert wide.ode_f.f[0].weight.detach()[6:].abs().max() > 0


def test_hetero_super_config_matches_jax_and_rejects_mismatch():
    c1 = njode.NJODEConfig(1, 6, 1, ((8, "tanh"),), ((8, "tanh"),),
                           ((8, "tanh"),))
    c2 = njode.NJODEConfig(1, 8, 1, ((8, "tanh"),), ((8, "tanh"),),
                           ((8, "tanh"),))
    with pytest.raises(ValueError):
        vmap_sweep.hetero_super_config([c1, c2])
    a = njode.NJODEConfig(1, 6, 1, ((8, "tanh"), (4, "relu")),
                          ((12, "tanh"),), ((3, "tanh"),))
    b = njode.NJODEConfig(1, 6, 1, ((5, "tanh"), (9, "relu")),
                          ((2, "tanh"),), ((7, "tanh"),))
    got = vmap_sweep.hetero_super_config([a, b])
    ja, jb = (jnjode.NJODEConfig(1, 6, 1, c.ode_nn, c.readout_nn, c.enc_nn)
              for c in (a, b))
    want = jvmap.hetero_super_config([ja, jb])
    assert (got.ode_nn, got.readout_nn, got.enc_nn) == (
        want.ode_nn, want.readout_nn, want.enc_nn)
