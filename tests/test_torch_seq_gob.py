"""The port's sequential GRU-ODE-Bayes (``SeqGOB``, ``seq_forward``) and
its collate (``data/climate.seq_collate``) against the JAX package's
``seq_forward`` + ``jax.grad`` and ``seq_collate``, with the JAX
parameters carried across (``jax_compat.seq_state_dict_from_jax_params``).

Tolerances: loss rtol 1e-5 / atol 1e-6, the path and the final state rtol
1e-5 / atol 1e-6, gradients rtol 2e-4 with an atol of 2e-5 scaled by the
largest |g| (``torch_port_helpers.gob_grad_tol``: the loss is a sum with
1/s2^2 = 1e4 KL factors); the collate exactly."""

import numpy as np
import pandas as pd
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.data import climate as jclimate
from njode_tpu.data import grid as jgrid
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu_torch.data import climate as tclimate
from njode_tpu_torch.data import grid as tgrid
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.training import jax_compat

PATH_TOL = dict(rtol=1e-5, atol=1e-6)


def _frame(seed=41, B=6, D=2):
    """Long-format rows on the 0.25 grid (as tests/test_gru_ode_bayes.py
    makes them), as a pandas frame for JAX and a dict of columns for the
    port."""
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(B):
        times = np.sort(rs.choice(np.arange(1, 16), rs.randint(2, 6),
                                  replace=False)) * 0.25
        for t in times:
            mask = rs.randint(0, 2, D)
            if mask.sum() == 0:
                mask[rs.randint(D)] = 1
            vals = rs.normal(0, 1, D) * mask
            rows.append([i, t] + list(vals) + list(mask))
    cols = (["ID", "Time"] + [f"Value_{j}" for j in range(D)]
            + [f"Mask_{j}" for j in range(D)])
    df = pd.DataFrame(rows, columns=cols).astype(np.float32)
    return df, {c: df[c].to_numpy() for c in cols}


def _batch(sb, n, D, cov_size):
    b = jgrid.batch_from_events(
        np.asarray(sb["times"], np.float64), np.asarray(sb["time_ptr"]),
        sb["X"], sb["obs_idx"], 0.25, 4.0, np.zeros((n, D), np.float32),
        M=sb["M"])
    rs = np.random.RandomState(5)
    cov = rs.normal(0, 1, (n, cov_size)).astype(np.float32)
    return jgrid.recompute_n_obs(b)._replace(start_X=cov)


@pytest.mark.parametrize("seed", [41, 7])
def test_seq_collate_matches_jax(seed):
    df, frame = _frame(seed=seed, B=9, D=3)
    ref = jclimate.seq_collate(df, 3)
    out = tclimate.seq_collate(frame, 3)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def _twins(full, seed=2):
    kw = dict(input_size=2, hidden_size=9, p_hidden=7, prep_hidden=3,
              cov_size=2, cov_hidden=5, mixing=0.3, full_gru_ode=full)
    jcfg, tcfg = jgob.SeqConfig(**kw), tgob.SeqConfig(**kw)
    params = jgob.seq_init_params(jax.random.PRNGKey(seed), jcfg)
    model = tgob.SeqGOB(tcfg)
    model.load_state_dict(jax_compat.seq_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, model


@pytest.mark.parametrize("full", [False, True], ids=["minimal", "full"])
def test_seq_forward_loss_path_and_grads_match_jax(full):
    df, frame = _frame()
    n = int(df["ID"].nunique())
    b = _batch(tclimate.seq_collate(frame, 2), n, 2, 2)
    jcfg, params, model = _twins(full)

    def loss_jax(p):
        return jgob.seq_forward(p, jcfg, H.jbatch(b), get_loss=True)[1]

    l_ref, g_ref = jax.value_and_grad(loss_jax)(params)
    h_ref, _, (p0r, prer, postr) = jgob.seq_forward(
        params, jcfg, H.jbatch(b), get_loss=True, return_path=True)
    h, loss = tgob.seq_forward(model, H.tbatch(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    grads = jax_compat.seq_jax_params_from_state_dict(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in model.named_parameters()})
    ref = H.flat({k: v for k, v in g_ref.items() if k != "class_model"})
    got = H.flat({k: v for k, v in grads.items() if k != "class_model"})
    np.testing.assert_allclose(got, ref, **H.gob_grad_tol(ref))
    with torch.no_grad():
        h2, loss2, (p0, pre, post) = tgob.seq_forward(
            model, H.tbatch(b), return_path=True)
    np.testing.assert_allclose(float(loss2), float(l_ref), **H.LOSS_TOL)
    for a, r in ((h2, h_ref), (p0, p0r), (pre, prer), (post, postr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **PATH_TOL)
    assert pre.shape == (b.obs.shape[0], n, 4)


def test_seq_weight_carrier_round_trip():
    _, params, model = _twins(True)
    back = jax_compat.seq_jax_params_from_state_dict(model.state_dict())
    np.testing.assert_array_equal(H.flat(back),
                                  H.flat(jax.tree.map(np.asarray, params)))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree.map(np.asarray, params))
    n_torch = sum(p.numel() for p in model.parameters())
    assert n_torch == H.flat(back).size
