"""The port's event-format losses (``models/losses.py``: ``compute_loss``,
``compute_loss_2``, ``LOSS_FUN_DICT``) and the trainer's
``compute_optimal_eval_loss`` against the JAX package's, on seeded numpy
inputs."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.data import sde as jsde
from njode_tpu.models import losses as jlosses
from njode_tpu.training import trainer as jtrainer
from njode_tpu_torch.data import sde as tsde
from njode_tpu_torch.models import losses as tlosses
from njode_tpu_torch.training import trainer as ttrainer


def _rows(seed, n, D, masked):
    rs = np.random.RandomState(seed)
    arrs = [rs.normal(size=(n, D)).astype(np.float32) for _ in range(3)]
    n_obs = rs.randint(1, 5, size=n).astype(np.float32)
    M = ((rs.random_sample((n, D)) < 0.6).astype(np.float32)
         if masked else None)
    return arrs, n_obs, M


@pytest.mark.parametrize("which", ["standard", "easy"])
@pytest.mark.parametrize("D,masked,weight", [(1, False, 0.5), (3, False, 0.7),
                                             (3, True, 0.4)])
def test_event_losses_match_jax(which, D, masked, weight):
    (X, Y, Y_bj), n_obs, M = _rows(5 + D, 11, D, masked)
    assert list(tlosses.LOSS_FUN_DICT) == list(jlosses.LOSS_FUN_DICT)
    tfn, jfn = tlosses.LOSS_FUN_DICT[which], jlosses.LOSS_FUN_DICT[which]
    assert tfn is {"standard": tlosses.compute_loss,
                   "easy": tlosses.compute_loss_2}[which]
    tl = tfn(*(torch.as_tensor(a) for a in (X, Y, Y_bj, n_obs)), 7,
             weight=weight, M_obs=None if M is None else torch.as_tensor(M))
    jl = jfn(*(jnp.asarray(a) for a in (X, Y, Y_bj, n_obs)), 7,
             weight=weight, M_obs=None if M is None else jnp.asarray(M))
    np.testing.assert_allclose(float(tl), float(jl), **H.LOSS_TOL)


@pytest.mark.parametrize("name,hp,D", [
    ("BlackScholes", dict(drift=2., volatility=0.3, nb_paths=8, nb_steps=15,
                          S0=1., maturity=1., dimension=1), 1),
    ("OrnsteinUhlenbeck", dict(volatility=0.3, mean=4., speed=2.,
                               nb_paths=8, nb_steps=15, S0=1., maturity=1.,
                               dimension=2), 2)])
def test_compute_optimal_eval_loss_matches_jax(name, hp, D):
    b = H.make_np_batch(seed=4, D=D, pad=1)
    jm, tm = jsde.make_model(name, hp), tsde.make_model(name, hp)
    jl = jtrainer.compute_optimal_eval_loss(b, jm, 1.0 / 15, 1.0)
    tl = ttrainer.compute_optimal_eval_loss(H.tbatch(b), tm, 1.0 / 15, 1.0)
    assert isinstance(tl, float)
    np.testing.assert_allclose(tl, jl, **H.LOSS_TOL)
