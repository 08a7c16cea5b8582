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
