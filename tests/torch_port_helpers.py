"""Shared inputs for the tests that hold njode_tpu_torch against njode_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX parameters come from ``njode.init_params`` and are carried into the
port's modules by ``training/jax_compat.py``."""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from njode_tpu.data import grid as jgrid
from njode_tpu.models import njode as jnjode
from njode_tpu_torch.data import grid as tgrid
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.training.jax_compat import (jax_params_from_state_dict,
                                                 state_dict_from_jax_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NN = ((13, "tanh"), (7, "relu"))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def make_np_batch(seed=0, B=8, D=1, steps=15, obs_perc=0.35, pad=0):
    """A grid batch (numpy) as tests/test_fused_scan.py makes it, with
    ``pad`` dt==0 padding steps appended."""
    rs = np.random.RandomState(seed)
    dt = 1.0 / steps
    paths = rs.lognormal(0.0, 0.3, size=(B, D, steps + 1))
    observed = (rs.random((B, steps + 1)) < obs_perc).astype(np.int64)
    observed[0, steps] = 1
    for i in range(B):
        if observed[i, 1:].sum() == 0:
            observed[i, 3] = 1
    b = jgrid.recompute_n_obs(jgrid.batch_from_paths(paths, observed, dt))
    if pad:
        b = b._replace(
            times=np.concatenate([b.times, np.full(pad, 1.0, np.float32)]),
            dt=np.concatenate([b.dt, np.zeros(pad, np.float32)]),
            obs=np.concatenate([b.obs, np.zeros((pad, B), np.float32)]),
            X=np.concatenate([b.X, np.zeros((pad, B, D), np.float32)]),
            M=np.concatenate([b.M, np.zeros((pad, B, D), np.float32)]))
    return b


def make_masked_np_batch(seed=0, B=8, D=2, steps=15, obs_perc=0.4):
    """Batch with partial coordinate masks."""
    b = make_np_batch(seed=seed, B=B, D=D, steps=steps, obs_perc=obs_perc)
    rs = np.random.RandomState(seed + 100)
    m = (rs.random(b.X.shape) < 0.6).astype(np.float32)
    m[..., 0] = 1.0
    M = m * b.obs[:, :, None]
    return b._replace(M=M, X=b.X * M)


def jbatch(b):
    return jax.tree.map(jnp.asarray, b)


def tbatch(b):
    return tgrid.to_torch(b, "cpu")


def configs(D, H, **kw):
    """The same configuration for both packages."""
    args = dict(input_size=D, hidden_size=H, output_size=D, ode_nn=NN,
                readout_nn=NN, enc_nn=NN)
    args.update(kw)
    return jnjode.NJODEConfig(**args), tnjode.NJODEConfig(**args)


def twin_models(jcfg, tcfg, seed=1):
    """JAX params from ``init_params`` and the port's module holding the
    same weights."""
    params = jnjode.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tnjode.NJODE(tcfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    return params, model


def torch_grads_as_jax(model):
    """The port's parameter gradients as a JAX-layout pytree."""
    return jax_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(x)) for x in
                           jax.tree_util.tree_leaves(tree)])


def make_gob_np_batch(seed=0, B=6, D=2, steps=12, obs_perc=0.4, pad=2):
    """A GRU-ODE-Bayes batch (numpy) as tests/test_fused_gob.py makes it:
    partial coordinate masks and ``pad`` dt==0 padding steps at the tail."""
    rs = np.random.RandomState(seed)
    dt = 1.0 / steps
    paths = rs.lognormal(0.0, 0.3, size=(B, D, steps + 1))
    observed = (rs.random((B, steps + 1)) < obs_perc).astype(np.int64)
    observed[0, steps] = 1
    for i in range(B):
        if observed[i, 1:].sum() == 0:
            observed[i, 3] = 1
    b = jgrid.recompute_n_obs(jgrid.batch_from_paths(paths, observed, dt))
    m = (rs.random(b.M.shape) < 0.7).astype(np.float32)
    m[..., 0] = 1.0
    M = m * b.obs[:, :, None]
    f32 = np.float32
    return b._replace(
        times=np.concatenate([b.times, np.full(pad, float(b.times[-1]))]
                             ).astype(f32),
        dt=np.concatenate([b.dt, np.zeros(pad)]).astype(f32),
        obs=np.concatenate([b.obs, np.zeros((pad, B))]).astype(f32),
        X=np.concatenate([b.X * M, np.zeros((pad, B, D))]).astype(f32),
        M=np.concatenate([M, np.zeros((pad, B, D))]).astype(f32))


# the 13 configurations of tests/test_fused_gob.py (the fused kernels'
# whole scope)
GOB_CONFIGS = [
    dict(),                                          # minimal, no impute
    dict(impute=True),
    dict(full_gru_ode=True),
    dict(full_gru_ode=True, impute=True),
    dict(logvar=False, impute=True),
    dict(solver="midpoint", impute=True),
    dict(solver="midpoint"),
    dict(solver="midpoint", full_gru_ode=True, impute=True,
         dropout_rate=0.1),
    dict(discretized=True, impute=True),
    dict(discretized=True),
    dict(impute=True, dropout_rate=0.1),
    dict(full_gru_ode=True, logvar=False),
    dict(bias=False, impute=True),
]
GOB_IDS = ["minimal", "impute", "full", "full_impute", "absvar_impute",
           "mid_impute", "mid", "mid_full_impute_drop", "disc_impute",
           "disc", "impute_drop", "full_absvar", "nobias_impute"]


def gob_grad_tol(ref):
    """The gradient tolerance of the GOB comparisons: rtol 2e-4 and an
    atol of 2e-5 scaled by the largest |g| (at least 1). The GOB loss is a
    sum over observations with 1/var and 1/s2^2 = 1e4 factors (KL, the
    abs-var NLL), so gradients reach the thousands and a reordered float
    sum moves small entries by more than 2e-5 (tests/test_fused_gob.py
    scales its mesh check the same way)."""
    return dict(rtol=2e-4,
                atol=2e-5 * max(1.0, float(np.abs(np.asarray(ref)).max())))


def gob_configs(D=2, **kw):
    """The same GOB configuration for both packages (the small widths of
    tests/test_fused_gob.py)."""
    from njode_tpu.models import gru_ode_bayes as jgob
    from njode_tpu_torch.models import gru_ode_bayes as tgob

    args = dict(input_size=D, hidden_size=9, p_hidden=7, prep_hidden=5,
                cov_size=D, cov_hidden=6, mixing=1e-2)
    args.update(kw)
    return jgob.GOBConfig(**args), tgob.GOBConfig(**args)


def gob_twin_models(jcfg, tcfg, seed=1):
    from njode_tpu.models import gru_ode_bayes as jgob
    from njode_tpu_torch.models import gru_ode_bayes as tgob
    from njode_tpu_torch.training.jax_compat import \
        gob_state_dict_from_jax_params

    params = jgob.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tgob.GOB(tcfg)
    model.load_state_dict(gob_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    return params, model


def gob_torch_grads_as_jax(model):
    from njode_tpu_torch.training.jax_compat import \
        gob_jax_params_from_state_dict

    return gob_jax_params_from_state_dict(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in model.named_parameters()})


def gob_jax_drop_masks(jcfg, rng, K, B):
    """The keep-masks gru_ode_bayes.forward draws from ``rng``: ``(u0_cov,
    u0_p, u [K,3,B,P])`` as numpy bool."""
    _, k_scan = jax.random.split(rng)
    k_u, k_u0c, k_u0p = jax.random.split(jax.random.fold_in(k_scan, 7), 3)
    keep = np.float32(1.0 - jcfg.dropout_rate)

    def draw(k, shape):
        u = jax.random.uniform(k, shape, dtype=jnp.bfloat16)
        return np.asarray(u.astype(jnp.float32)) < keep

    return (draw(k_u0c, (B, jcfg.cov_hidden)), draw(k_u0p, (B, jcfg.p_hidden)),
            draw(k_u, (K, 3, B, jcfg.p_hidden)))


def jax_drop_masks(jcfg, rng, K, B):
    """The keep-masks njode.forward draws from ``rng`` (fused-draw regime):
    ``(u0, u)`` as numpy bool."""
    n_ode, n_enc, n_ro, w_max = jnjode._dropout_slots(jcfg)
    S = n_ode + n_enc + 2 * n_ro
    _, k_scan = jax.random.split(rng, 2)
    k_u0, k_u = jax.random.split(k_scan)
    assert K * S * B * w_max * 2 <= jnjode.FUSED_DRAW_BUDGET
    keep = np.float32(1.0 - jcfg.dropout_rate)
    u = jax.random.uniform(k_u, (K, S, B, w_max), dtype=jnp.bfloat16)
    u0 = jax.random.uniform(k_u0, (max(n_enc, 1), B, w_max),
                            dtype=jnp.bfloat16)
    return (np.asarray(u0.astype(jnp.float32)) < keep,
            np.asarray(u.astype(jnp.float32)) < keep)
