"""The port's eager GRU-ODE-Bayes (models/gru_ode_bayes.py) against the JAX
package's ``gru_ode_bayes.forward`` + ``jax.grad``, with the same weights,
inputs and dropout masks, over the 13 configurations the fused kernels
cover; plus ``evaluate``/``get_pred``, the weight carrier and the config.

Tolerances: loss rtol 1e-5 / atol 1e-6, gradients rtol 2e-4 / atol 2e-5
(the Pallas kernel's, tests/test_fused_gob.py)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.training import jax_compat


def _flat_no_class(tree):
    return H.flat({k: v for k, v in tree.items() if k != "class_model"})


@pytest.mark.parametrize("kw", H.GOB_CONFIGS, ids=H.GOB_IDS)
@pytest.mark.parametrize("train", [False, True])
def test_forward_loss_and_grads_match_jax(kw, train):
    """Loss and every parameter gradient, with ``dt==0`` padding steps and
    partial coordinate masks in the batch (D = 2)."""
    jcfg, tcfg = H.gob_configs(**kw)
    params, model = H.gob_twin_models(jcfg, tcfg)
    b = H.make_gob_np_batch(seed=3)
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(7)

    def loss_jax(p):
        return jgob.forward(p, jcfg, H.jbatch(b), rng=rng, train=train,
                            get_loss=True)[1]

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss_jax))(params)
    masks = (H.gob_jax_drop_masks(jcfg, rng, K, B)
             if train and jcfg.dropout_rate > 0 else None)
    _, loss = tgob.forward(model, H.tbatch(b), train=train, drop_masks=masks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(
        _flat_no_class(H.gob_torch_grads_as_jax(model)),
        _flat_no_class(g_ref), **H.GRAD_TOL)


@pytest.mark.parametrize("logvar", [True, False])
def test_forward_published_width_shape_d1(logvar):
    """D = 1 (the published comparison's scalar series), full field,
    impute, mixing 0.5: KL gradients reach the thousands, so the gradient
    atol is scaled by the largest |g| (as tests/test_fused_gob.py does for
    its mesh check)."""
    jcfg, tcfg = H.gob_configs(D=1, full_gru_ode=True, impute=True,
                               logvar=logvar, mixing=0.5, dropout_rate=0.1)
    params, model = H.gob_twin_models(jcfg, tcfg, seed=2)
    b = H.make_gob_np_batch(seed=4, D=1, B=7, steps=14)
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(3)
    l_ref, g_ref = jax.value_and_grad(lambda p: jgob.forward(
        p, jcfg, H.jbatch(b), rng=rng, train=True)[1])(params)
    masks = H.gob_jax_drop_masks(jcfg, rng, K, B)
    _, loss = tgob.forward(model, H.tbatch(b), train=True, drop_masks=masks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    gr = _flat_no_class(g_ref)
    scale = float(np.abs(gr).max())
    np.testing.assert_allclose(
        _flat_no_class(H.gob_torch_grads_as_jax(model)), gr, rtol=2e-4,
        atol=2e-5 * max(scale, 1.0))


def test_evaluate_and_pred_match_jax():
    from njode_tpu.data import sde as jsde
    from njode_tpu_torch.data import sde as tsde

    hp = dict(drift=2.0, volatility=0.3, nb_paths=8, nb_steps=15)
    jcfg, tcfg = H.gob_configs(D=1, full_gru_ode=True, impute=True)
    params, model = H.gob_twin_models(jcfg, tcfg)
    b = H.make_np_batch(seed=4, D=1)
    ref = jgob.evaluate(params, jcfg, H.jbatch(b),
                        jsde.make_model("BlackScholes", hp).next_cond_exp)
    got = tgob.evaluate(model, H.tbatch(b),
                        tsde.make_model("BlackScholes", hp).next_cond_exp)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    pj = jgob.get_pred(params, jcfg, H.jbatch(b))
    pt = tgob.get_pred(model, H.tbatch(b))
    for k in ("pred_t", "pred", "pred_bj"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(full_gru_ode=True, impute=True),
                                dict(discretized=True, bias=False)],
                         ids=["minimal", "full_impute", "disc_nobias"])
def test_jax_compat_round_trip(kw):
    """JAX pytree -> state_dict -> JAX pytree is the identity, and the
    state_dict holds exactly the module's keys and shapes."""
    jcfg, tcfg = H.gob_configs(**kw)
    params, model = H.gob_twin_models(jcfg, tcfg)
    sd = jax_compat.gob_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params))
    ref = tgob.GOB(tcfg).state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k
    back = jax_compat.gob_jax_params_from_state_dict(model.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, params)))
    for a, c in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), c)


def test_state_dict_keys_are_the_references():
    _, tcfg = H.gob_configs(full_gru_ode=True, impute=True)
    keys = set(tgob.GOB(tcfg).state_dict())
    for k in ("p_model.0.weight", "p_model.3.bias",
              "covariates_map.0.weight", "covariates_map.3.bias",
              "classification_model.0.weight", "gru_c.lin_x.weight",
              "gru_c.lin_hh.weight", "gru_c.lin_hz.weight",
              "gru_c.lin_hr.weight", "gru_obs.gru_d.weight_ih",
              "gru_obs.gru_d.bias_hh", "gru_obs.w_prep",
              "gru_obs.bias_prep"):
        assert k in keys, k
    _, dcfg = H.gob_configs(discretized=True)
    assert "gru_c.weight_hh" in tgob.GOB(dcfg).state_dict()


def test_init_follows_the_reference_and_the_generator():
    """Linear biases 0.05, bias_prep 0.1, w_prep std sqrt(2/(4+prep)), and
    the same generator seed gives the same weights."""
    _, tcfg = H.gob_configs(D=1, hidden_size=40, prep_hidden=60)
    m1 = tgob.GOB(tcfg, generator=torch.Generator().manual_seed(5))
    m2 = tgob.GOB(tcfg, generator=torch.Generator().manual_seed(5))
    for (k, a), (_, c) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, c), k
    assert torch.all(m1.p_model[0].bias == 0.05)
    assert torch.all(m1.gru_obs.bias_prep == 0.1)
    std = float(m1.gru_obs.w_prep.detach().std())
    assert abs(std - np.sqrt(2.0 / 64)) < 0.04


def test_config_from_options_defaults():
    pd = {"input_size": 1, "hidden_size": 50, "bias": True,
          "dropout_rate": 0.1}
    t = tgob.config_from_options(pd, {})
    j = jgob.config_from_options(pd, {})
    assert t.__dict__ == j.__dict__
    assert (t.p_hidden, t.prep_hidden, t.cov_hidden) == (50, 50, 50)
    assert t.full_gru_ode and not t.impute and t.logvar
    assert t.mixing == 1e-4 and t.solver == "euler"
    opts = {"GRU_ODE_Bayes-impute": True, "GRU_ODE_Bayes-mixing": 0.5,
            "GRU_ODE_Bayes-logvar": False}
    assert (tgob.config_from_options(pd, opts).__dict__
            == jgob.config_from_options(pd, opts).__dict__)


@pytest.mark.parametrize("train", [False, True])
def test_dopri5(train):
    """dopri5 with impute warns and runs the midpoint scheme, as in JAX;
    the autonomous dopri5 runs through ops/odeint.py (one Dormand-Prince
    step per interval in training, the adaptive integrator in eval) and
    matches JAX's loss (and, in training, its gradients)."""
    with pytest.warns(UserWarning, match="midpoint"):
        _, tcfg = H.gob_configs(solver="dopri5", impute=True)
    assert tgob.propagation_mode(tcfg) == "midpoint"
    jcfg, acfg = H.gob_configs(solver="dopri5", impute=False,
                               full_gru_ode=True)
    assert tgob.propagation_mode(acfg) == "dopri5"
    params, model = H.gob_twin_models(jcfg, acfg)
    b = H.make_gob_np_batch(seed=3)
    if not train:
        # the adaptive eval integrator (a while_loop in JAX) has no
        # reverse mode: compare the loss
        _, l_ref = jgob.forward(params, jcfg, H.jbatch(b), train=False)
        with torch.no_grad():
            _, loss = tgob.forward(model, H.tbatch(b), train=False)
        np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)
        return
    l_ref, g_ref = jax.value_and_grad(lambda p: jgob.forward(
        p, jcfg, H.jbatch(b), train=True)[1])(params)
    _, loss = tgob.forward(model, H.tbatch(b), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    ref = _flat_no_class(g_ref)
    np.testing.assert_allclose(
        _flat_no_class(H.gob_torch_grads_as_jax(model)), ref,
        **H.gob_grad_tol(ref))
