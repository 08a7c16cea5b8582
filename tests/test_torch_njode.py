"""The port's eager NJODE forward (loss and autograd gradients) against the
JAX package's ``njode.forward`` + ``jax.grad``, with the same weights,
inputs and dropout masks."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu_torch.models import njode as tnjode

# (name, config overrides, D, H, masked batch)
VARIANTS = [
    ("main", dict(), 1, 10, False),
    ("masked", dict(masked=True), 2, 12, True),
    ("use_rnn", dict(use_rnn=True), 2, 10, False),
    ("input_current_t", dict(input_current_t=True), 1, 10, False),
    ("easy", dict(which_loss="easy"), 2, 10, False),
    ("residual_case0", dict(residual_enc_dec=False), 2, 10, False),
    # D > H: the encoder's residual is case 2 (mean of chunks), the
    # readout's case 1 (tiled)
    ("residual_case2", dict(), 4, 2, False),
]


def _run(variant, train, pad=0):
    _, kw, D, Hd, masked = variant
    if train:
        kw = dict(kw, dropout_rate=0.1)
    jcfg, tcfg = H.configs(D, Hd, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = (H.make_masked_np_batch(seed=3, D=D) if masked
         else H.make_np_batch(seed=3, D=D, pad=pad))
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(7)
    weight = 0.7

    def loss_jax(p):
        return jnjode.forward(p, jcfg, H.jbatch(b), weight=weight, rng=rng,
                              train=train)[1]

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss_jax))(params)
    masks = H.jax_drop_masks(jcfg, rng, K, B) if train else None
    _, loss = tnjode.forward(model, H.tbatch(b), weight=weight, train=train,
                             drop_masks=masks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(model)),
                               H.flat(g_ref), **H.GRAD_TOL)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("train", [False, True])
def test_forward_loss_and_grads_match_jax(variant, train):
    _run(variant, train)


@pytest.mark.parametrize("train", [False, True])
def test_forward_padding_steps(train):
    """dt==0 padding steps are no-ops in the loss and the gradients."""
    _run(VARIANTS[0], train, pad=3)


def test_state_dict_keys_are_the_references():
    _, tcfg = H.configs(1, 10, use_rnn=True)
    keys = set(tnjode.NJODE(tcfg).state_dict())
    for k in ("ode_f.f.0.weight", "ode_f.f.3.bias", "ode_f.f.6.weight",
              "encoder_map.ffnn.0.weight", "readout_map.ffnn.6.bias",
              "obs_c.gru_d.weight_ih", "obs_c.gru_d.bias_hh"):
        assert k in keys, k


def test_jax_compat_round_trip():
    jcfg, tcfg = H.configs(2, 10, use_rnn=True)
    params, model = H.twin_models(jcfg, tcfg)
    back = H.jax_params_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the same state_dict as the JAX package's own exporter
    from njode_tpu.training.torch_compat import torch_state_from_njode_params
    ref = torch_state_from_njode_params(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())


def test_evaluate_and_pred_match_jax():
    """``evaluate`` (oracle mean-squared difference) and ``get_pred``."""
    from njode_tpu.data import sde as jsde
    from njode_tpu_torch.data import sde as tsde

    hp = dict(drift=2.0, volatility=0.3, nb_paths=8, nb_steps=15)
    jcfg, tcfg = H.configs(1, 10)
    params, model = H.twin_models(jcfg, tcfg)
    b = H.make_np_batch(seed=4, D=1)
    ref = jnjode.evaluate(params, jcfg, H.jbatch(b),
                          jsde.make_model("BlackScholes", hp).next_cond_exp)
    got = tnjode.evaluate(model, H.tbatch(b),
                          tsde.make_model("BlackScholes", hp).next_cond_exp)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    pj = jnjode.get_pred(params, jcfg, H.jbatch(b))
    pt = tnjode.get_pred(model, H.tbatch(b))
    for k in ("pred_t", "pred", "pred_bj"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-5, atol=1e-6)
    assert tnjode.weight_decay_step(0.9, 0.5) == pytest.approx(0.7)


def test_draw_masks_uses_the_generator():
    _, tcfg = H.configs(1, 10, dropout_rate=0.1)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tnjode.draw_masks(tcfg, 5, 4, g1, "cpu")
    b = tnjode.draw_masks(tcfg, 5, 4, g2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[1].shape == (5, 8, 4, 13)
