"""Tensor parallelism of the port (parallel/sharding.py's make_mesh_2d,
ffnn_tp_specs, njode_tp_sharding, shard_model and parallel/
tensor_parallel.py) against the JAX package: four gloo ranks spawned on the
CPU once for the file (``torch_tp_ranks.tp_checks``).

- the specs equal the JAX package's ``tuple(PartitionSpec)``s, for the
  shapes of tests/test_sharding.py and the main path's nets at axis sizes
  1, 2 and 4;
- the eval loss at mp = 2 (the 2 x 2 mesh) and mp = 4 (1 x 4) against
  ``njode.forward`` with the JAX parameters carried across, rtol 1e-5 (the
  tolerance of test_tp_sharding_matches_replicated);
- one DP x TP train step (2 x 2) at dropout 0 against JAX's replicated
  loss and gradients at the North-star tolerances (loss rtol 1e-5 / atol
  1e-6, gradients rtol 2e-4 / atol 2e-5); at dropout 0.1 against the
  port's unsharded step (torch cannot replay JAX's draws), the same
  tolerances and the parameters after Adam at rtol 1e-4 / atol 1e-6 (the
  dry run's); in bfloat16 at mp = 4 against the port's unsharded bfloat16
  step, the same tolerances;
- the Adam state cut with the model; a mesh whose model axis does not
  divide the ranks, the fused kernels on a 2-D mesh and an uncut model
  are refused."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch
from torch import nn

import torch_port_helpers as H
import torch_tp_ranks
from njode_tpu.models import njode as jnjode
from njode_tpu.parallel import sharding as jsharding
from njode_tpu.training import steps as jsteps
from njode_tpu_torch.ops import fused_gob as fg
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.parallel import sharding

pytestmark = pytest.mark.subprocess

W16 = ((16, "tanh"), (16, "tanh"))
W50 = ((50, "tanh"), (50, "tanh"))
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _sharding_batch():
    """tests/test_sharding.py's ``_setup`` batch (B = 16, K = 10)."""
    from njode_tpu.data.grid import batch_from_paths, recompute_n_obs
    rs = np.random.RandomState(0)
    B, K = 16, 10
    paths = rs.lognormal(0, 0.2, (B, 1, K + 1))
    obs = (rs.random((B, K + 1)) < 0.3).astype(np.int64)
    return recompute_n_obs(batch_from_paths(paths, obs, 1.0 / K))


def _step_data():
    rs = np.random.RandomState(3)
    N, K, B = 16, 15, 8
    paths = rs.lognormal(0, 0.3, (N, 1, K + 1)).astype(np.float32)
    obs = (rs.random((N, K + 1)) < 0.35).astype(np.float32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)
    idx = rs.permutation(N)[:B]
    return dict(paths=paths, obs=obs, times=times, dts=dts, idx=idx)


def _torch_data(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _case():
    j16, t16 = H.configs(1, 10, ode_nn=W16, readout_nn=W16, enc_nn=W16)
    p16, m16 = H.twin_models(j16, t16, seed=0)
    jm, tm = H.configs(1, 10, ode_nn=W50, readout_nn=W50, enc_nn=W50)
    pm, mm = H.twin_models(jm, tm, seed=1)
    js, ts = H.configs(1, 10, ode_nn=W16, readout_nn=W16, enc_nn=W16)
    _, ts1 = H.configs(1, 10, ode_nn=W16, readout_nn=W16, enc_nn=W16,
                       dropout_rate=0.1)
    _, tsb = H.configs(1, 10, ode_nn=W16, readout_nn=W16, enc_nn=W16,
                       dropout_rate=0.1, compute_dtype="bfloat16")
    ps, ms = H.twin_models(js, ts, seed=2)
    b16 = _sharding_batch()
    data = _step_data()
    return dict(
        s16=dict(cfg=t16, state=m16.state_dict(), batch=H.tbatch(b16)),
        main=dict(cfg=tm, state=mm.state_dict()),
        step=dict(cfg0=ts, cfg=ts1, cfg_bf16=tsb, state=ms.state_dict(),
                  data=_torch_data(data)),
        jax=dict(s16=(j16, p16, b16), main=(jm, pm), step=(js, ps, data)))


@pytest.fixture(scope="module")
def run():
    case = _case()
    jax_side = case.pop("jax")
    outs = sharding.spawn(torch_tp_ranks.tp_checks, 4, args=(case,),
                          wait=600)
    return dict(case=case, jax=jax_side, outs=outs)


def _jax_specs(layers, size):
    return [{k: tuple(v) for k, v in s.items()}
            for s in jsharding.ffnn_tp_specs(layers, "model", size)]


@pytest.mark.parametrize("size", [1, 2, 4])
def test_ffnn_tp_specs_equal_jax(size):
    """tests/test_sharding.py's three layers (4 -> 16 -> 16 -> 2), as
    torch Linears, against the JAX package's ``{"w": [in, out]}`` dicts."""
    jl = [{"w": np.zeros((4, 16)), "b": np.zeros(16)},
          {"w": np.zeros((16, 16)), "b": np.zeros(16)},
          {"w": np.zeros((16, 2)), "b": np.zeros(2)}]
    tl = [nn.Linear(4, 16), nn.Linear(16, 16), nn.Linear(16, 2)]
    ref = _jax_specs(jl, size)
    assert sharding.ffnn_tp_specs(tl, axis_size=size) == ref
    if size == 1:
        assert ref[0] == {"w": (None, "model"), "b": ("model",)}
        assert ref[1] == {"w": ("model", None), "b": ()}
        assert ref[2]["w"] == (None, "model")


def _fake_mesh(size):
    return sharding.Mesh2D((1, size), sharding.Mesh(1, 0),
                           sharding.Mesh(size, 0))


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("use_rnn", [False, True])
def test_njode_tp_sharding_equals_jax(size, use_rnn):
    """The main path's nets (hidden 10, three 2 x 50 tanh MLPs; with the
    GRU jump, replicated): each parameter's spec is the JAX package's
    ``njode_tp_sharding`` spec of the same leaf."""
    from njode_tpu_torch.training.jax_compat import _PREFIX
    jcfg, tcfg = H.configs(1, 10, ode_nn=W50, readout_nn=W50, enc_nn=W50,
                           use_rnn=use_rnn)
    params, model = H.twin_models(jcfg, tcfg)
    jmesh = jsharding.make_mesh_2d(8, model_parallel=size)
    jspec = jsharding.njode_tp_sharding(params, jmesh)
    got = sharding.njode_tp_sharding(model, _fake_mesh(size))
    assert set(got) == {k for k, _ in model.named_parameters()}
    for name, pfx in _PREFIX.items():
        for j, s in enumerate(jspec[name]):
            assert got[f"{pfx}.{3 * j}.weight"] == tuple(s["w"].spec)
            assert got[f"{pfx}.{3 * j}.bias"] == tuple(s["b"].spec)
    if use_rnn:
        assert all(tuple(s.spec) == () for s in jax.tree.leaves(
            jspec["gru"], is_leaf=lambda x: hasattr(x, "spec")))
        assert all(v == () for k, v in got.items()
                   if k.startswith("obs_c."))


def test_mesh_layout_matches_the_reshape(run):
    """Rank r: data index r // mp, model index r % mp (2 x 2 and 1 x 4)."""
    for out in run["outs"]:
        r = out["rank"]
        assert out["layout"] == (r // 2, r % 2, 2, 1, r)


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_eval_matches_jax_forward(run, mp):
    jcfg, params, b = run["jax"]["s16"]
    _, ref = jnjode.forward(params, jcfg, H.jbatch(b), train=False,
                            get_loss=True)
    for out in run["outs"]:
        np.testing.assert_allclose(out["eval16"][mp // 4], float(ref),
                                   rtol=1e-5)


def test_tp_eval_main_path_nets_matches_jax_forward(run):
    jcfg, params = run["jax"]["main"]
    _, _, b = run["jax"]["s16"]
    _, ref = jnjode.forward(params, jcfg, H.jbatch(b), train=False,
                            get_loss=True)
    for out in run["outs"]:
        np.testing.assert_allclose(out["eval_main"], float(ref), rtol=1e-5)


def _jax_step(jcfg, params, d):
    """JAX's replicated step's loss and gradients."""
    batch = jsteps.dense_batch(*(jnp.asarray(d[k][d["idx"]])
                                 for k in ("paths", "obs")),
                               jnp.asarray(d["times"]), jnp.asarray(d["dts"]))
    return jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, batch, weight=0.5, rng=jax.random.PRNGKey(0), train=True,
        get_loss=True)[1])(params)


def test_dp_tp_step_matches_jax_at_rate_0(run):
    jcfg, params, d = run["jax"]["step"]
    l_ref, g_ref = _jax_step(jcfg, params, d)
    for out in run["outs"]:
        loss, grads, _ = out["step0"]
        np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)
        np.testing.assert_allclose(
            H.flat(H.jax_params_from_state_dict(grads)), H.flat(g_ref),
            **H.GRAD_TOL)


def test_dp_tp_step_matches_the_unsharded_step_at_rate_01(run):
    st = run["case"]["step"]
    l_ref, g_ref, p_ref, _, _ = torch_tp_ranks.solo_step(
        st["cfg"], st["state"], st["data"])
    for out in run["outs"]:
        loss, grads, params = out["step_drop"]
        np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)
        for k in g_ref:
            np.testing.assert_allclose(grads[k], g_ref[k], **H.GRAD_TOL)
            np.testing.assert_allclose(params[k], p_ref[k], **PARAM_TOL)


def test_tp_step_matches_the_unsharded_step_in_bf16(run):
    """``compute_dtype='bfloat16'`` at mp = 4, dropout 0.1: each operand
    gradient is rounded to bfloat16 where the unsharded product rounds it
    (a column-parallel input gradient after the sum over the ranks), so
    the North-star tolerances hold; rounding each rank's partial instead
    moves the gradients by about 2e-3 relative."""
    st = run["case"]["step"]
    l_ref, g_ref, p_ref, _, _ = torch_tp_ranks.solo_step(
        st["cfg_bf16"], st["state"], st["data"])
    for out in run["outs"]:
        loss, grads, params = out["step_bf16"]
        np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)
        for k in g_ref:
            np.testing.assert_allclose(grads[k], g_ref[k], **H.GRAD_TOL)
            np.testing.assert_allclose(params[k], p_ref[k], **PARAM_TOL)


def test_adam_state_is_cut_with_the_model(run):
    st = run["case"]["step"]
    _, _, p_ref, _, _ = torch_tp_ranks.solo_step(st["cfg"], st["state"],
                                                 st["data"], steps=2)
    for out in run["outs"]:
        for k, v in p_ref.items():
            np.testing.assert_allclose(out["adam_carried"][k], v,
                                       **PARAM_TOL)


def test_refusals(run):
    for out in run["outs"]:
        e = out["errors"]
        assert "model_parallel=3 does not divide the 4 ranks" in e["mp3"]
        assert e["kernels"] == ("fused kernel sharding needs a 1-D mesh "
                                "over 'data'; got axes ('data', 'model')")
        assert "shard_model" in e["uncut"]


@pytest.mark.parametrize("factory", ["scan_loss", "scan_eval", "gob_loss"])
def test_fused_losses_raise_on_a_2d_mesh(factory):
    """With the JAX package's message (njode_tpu/ops/fused_scan.py:1381)."""
    cfg = H.configs(1, 10)[1]
    gcfg = H.gob_configs()[1]
    fn = {"scan_loss": lambda m: fs.make_fused_loss_fn(cfg, mesh=m),
          "scan_eval": lambda m: fs.make_fused_eval_fn(cfg, mesh=m),
          "gob_loss": lambda m: fg.make_fused_loss_fn(gcfg, mesh=m)}[factory]
    with pytest.raises(ValueError, match=r"fused kernel sharding needs a "
                       r"1-D mesh over 'data'; got axes \('data', 'model'\)"):
        fn(_fake_mesh(2))
