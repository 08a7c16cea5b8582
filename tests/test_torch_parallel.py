"""The port's data parallelism (njode_tpu_torch/parallel/) against the JAX
package: two gloo ranks spawned on the CPU (one spawn for every check of
this file, ``torch_parallel_ranks.loss_checks``) run the fused losses under
a 2-way mesh, the kernels' plain versions at 4 rows each.

- NJODE's loss (a batch mean, averaged over the ranks) and its gradients at
  dropout 0 against ``njode.forward`` + ``jax.grad`` on the global batch,
  and GRU-ODE-Bayes' (a sum, summed) against ``gru_ode_bayes.forward``:
  loss rtol 1e-5 / atol 1e-6, gradients rtol 2e-4 / atol 2e-5 (GOB: atol
  scaled by ``gob_grad_tol``). torch cannot replay JAX's threefry draws, so
  at dropout 0.1 the 2-rank loss is held to the port's own loss without a
  mesh ('input' mode: every rank draws the global masks and keeps its
  rows), at the same tolerances;
- a mesh of one equals no mesh bit for bit, in both mask modes;
- after one Adam step on the reduced gradient the parameters of both ranks
  are equal bit for bit;
- the evaluation forms (K3 at an even and an uneven split, K5's);
- the counterpart of tests/test_sharding.py's two-process test: both ranks
  resolve the same registry id, there is one registry row, one writer."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import torch_parallel_ranks
import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.models import njode as jnjode
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.ops import fused_gob as fg
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.parallel import multihost, sharding
from njode_tpu_torch.training import registry

pytestmark = pytest.mark.subprocess


def _case():
    jcfg0, tcfg0 = H.configs(1, 10)
    _, tcfg = H.configs(1, 10, dropout_rate=0.1)
    params, model = H.twin_models(jcfg0, tcfg0, seed=2)
    b = H.make_np_batch(seed=3, D=1, B=8, pad=2)
    b7 = H.make_np_batch(seed=4, D=1, B=7)
    gj0, gt0 = H.gob_configs(impute=True)
    _, gt = H.gob_configs(impute=True, dropout_rate=0.1)
    gparams, gmodel = H.gob_twin_models(gj0, gt0, seed=2)
    gbatch = H.make_gob_np_batch(seed=3)
    return dict(
        njode=dict(cfg0=tcfg0, cfg=tcfg, state=model.state_dict(),
                   batch=H.tbatch(b), batch7=H.tbatch(b7)),
        gob=dict(cfg0=gt0, cfg=gt, state=gmodel.state_dict(),
                 batch=H.tbatch(gbatch)),
        jax=dict(njode=(jcfg0, params, b), gob=(gj0, gparams, gbatch)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    case = _case()
    shared = str(tmp_path_factory.mktemp("parallel_shared"))
    jax_side = case.pop("jax")
    outs = sharding.spawn(torch_parallel_ranks.loss_checks, 2,
                          args=(case, shared), wait=600)
    return dict(case=case, jax=jax_side, outs=outs, shared=shared)


def _flat_njode_grads(grads):
    return H.flat(H.jax_params_from_state_dict(grads))


def _flat_gob_grads(grads, named):
    from njode_tpu_torch.training.jax_compat import \
        gob_jax_params_from_state_dict
    full = {k: grads.get(k, torch.zeros_like(p)) for k, p in named}
    tree = gob_jax_params_from_state_dict(full)
    return H.flat({k: v for k, v in tree.items() if k != "class_model"})


def test_njode_two_ranks_match_jax_global_batch(run):
    """The mean of the ranks' losses over 4 rows each, and the averaged
    gradients, are the global batch's (``pmean``)."""
    jcfg, params, b = run["jax"]["njode"]
    l_ref, g_ref = jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, H.jbatch(b), weight=0.7, rng=jax.random.PRNGKey(0),
        train=True)[1])(params)
    for out in run["outs"]:
        loss, grads = out["njode_rate0"]
        np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)
        np.testing.assert_allclose(_flat_njode_grads(grads), H.flat(g_ref),
                                   **H.GRAD_TOL)


def test_gob_two_ranks_match_jax_summed_loss(run):
    """GRU-ODE-Bayes' loss is a sum over observations: the ranks' sums and
    gradients summed (``psum``) are the global batch's."""
    jcfg, params, b = run["jax"]["gob"]
    l_ref, g_ref = jax.value_and_grad(lambda p: jgob.forward(
        p, jcfg, H.jbatch(b), rng=jax.random.PRNGKey(0), train=True)[1])(
        params)
    ref = H.flat({k: v for k, v in g_ref.items() if k != "class_model"})
    named = list(tgob.GOB(run["case"]["gob"]["cfg0"]).named_parameters())
    for out in run["outs"]:
        loss, grads = out["gob_rate0"]
        np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)
        np.testing.assert_allclose(_flat_gob_grads(grads, named), ref,
                                   **H.gob_grad_tol(ref))


def _solo(kind, mode):
    """The port's loss and gradients without a mesh, the generator seeded
    as the ranks seed theirs."""
    case = _case()
    c = case[kind]
    step = (torch_parallel_ranks._njode_step if kind == "njode"
            else torch_parallel_ranks._gob_step)
    loss, grads, _ = step(c["cfg"], c["state"], c["batch"], mode, None)
    return loss, grads


@pytest.mark.parametrize("kind", ["njode", "gob"])
def test_dropout_masks_drawn_globally_and_sliced(run, kind):
    """At dropout 0.1 in 'input' mode every rank draws the global masks
    from a generator in the same state and keeps its rows: the 2-rank
    loss and gradients are the port's own without a mesh."""
    loss_s, grads_s = _solo(kind, "input")
    for out in run["outs"]:
        loss, grads = out[f"{kind}_input"]
        np.testing.assert_allclose(float(loss), float(loss_s), **H.LOSS_TOL)
        assert set(grads) == set(grads_s)
        ref = torch.cat([g.reshape(-1) for g in grads_s.values()]).numpy()
        got = torch.cat([grads[k].reshape(-1) for k in grads_s]).numpy()
        tol = H.GRAD_TOL if kind == "njode" else H.gob_grad_tol(ref)
        np.testing.assert_allclose(got, ref, **tol)


def test_prng_mode_one_seed_a_rank_and_equal_steps(run):
    """'prng' mode: each rank's kernels draw from their own seed (rank r
    takes seed r of the shared draw), yet the reduced loss and gradients,
    and the parameters after an Adam step on them, are the same on both
    ranks bit for bit."""
    a, b = (out["njode_prng"] for out in run["outs"])
    assert torch.equal(a[0], b[0]) and np.isfinite(float(a[0]))
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert all(out["adam_same"] for out in run["outs"])


@pytest.mark.parametrize("what", ["one_njode_input", "one_njode_prng",
                                  "one_gob_input", "one_gob_prng",
                                  "one_eval"])
def test_mesh_of_one_equals_no_mesh_bit_for_bit(run, what):
    assert all(out[what] for out in run["outs"])


def test_eval_forms_reduce_to_the_global_batch(run):
    """K3's plain version at 4 + 4 and 4 + 3 rows, combined by the blocks'
    shares of the rows (``sharding.batch_mean``), and K5's eval form
    summed, against the port's evaluation of the whole batch."""
    c = _case()
    nj, gb = c["njode"], c["gob"]
    model = tnjode.NJODE(nj["cfg"])
    model.load_state_dict(nj["state"])
    ev = fs.make_fused_eval_fn(nj["cfg"])
    refs = [float(ev(model, b, 0.7)) for b in (nj["batch"], nj["batch7"])]
    gmodel = tgob.GOB(gb["cfg"])
    gmodel.load_state_dict(gb["state"])
    gref = float(fg.make_fused_eval_fn(gb["cfg"])(gmodel, gb["batch"]))
    for out in run["outs"]:
        for got, ref in zip(out["njode_eval"], refs):
            np.testing.assert_allclose(float(got), ref, **H.LOSS_TOL)
        np.testing.assert_allclose(float(out["gob_eval"]), gref,
                                   **H.LOSS_TOL)


def test_indivisible_batch_raises(run):
    """A training batch the mesh size does not divide raises instead of
    taking another path."""
    for out in run["outs"]:
        assert "not divisible by the 2-way mesh" in out["indivisible"]


def test_two_process_registry_coordination(run):
    """Both ranks resolve the same new id, the registry has one row, and
    only rank 0 ran the coordinator-only write; a broadcast carries rank
    0's value."""
    outs = run["outs"]
    assert [o["registry"] for o in outs] == [(1, False, None)] * 2
    assert [r[0] for r in registry.load_overview(run["shared"])] == [1]
    with open(os.path.join(run["shared"], "once.txt")) as f:
        assert f.read() == "writer=0\n"
    assert [o["coordinator_only"] for o in outs] == [0, None]
    assert [o["broadcast"] for o in outs] == [{"rank": 0}] * 2


def test_single_process_degrades_to_local_calls(tmp_path):
    """Without a process group the coordination helpers are plain local
    calls, ``initialize_distributed`` does nothing, and an object that is
    not a Mesh is refused."""
    assert not sharding.initialize_distributed()
    assert multihost.process_index() == 0 and multihost.is_coordinator()
    assert multihost.broadcast_from_coordinator(3) == 3
    assert multihost.coordinator_only(lambda: 5) == 5
    mid, _, _, resume = multihost.resolve_model_id_synced(
        str(tmp_path), None, "{}")
    assert (mid, resume) == (1, False)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        sharding.make_mesh()
    with pytest.raises(ValueError, match="1-D .*Mesh"):
        fs.make_fused_loss_fn(H.configs(1, 10)[1], mesh=object())


@pytest.mark.parametrize("n,size", [(8, 2), (7, 2), (3, 4), (10, 3)])
def test_mesh_rows_are_contiguous_blocks(n, size):
    """Rank r's rows: block r in rank order, the first ``n % size`` blocks
    one row longer; together every row once."""
    blocks = [sharding.Mesh(size, r).rows(n) for r in range(size)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    sizes = [hi - lo for lo, hi in blocks]
    assert sizes == sorted(sizes, reverse=True) and max(sizes) - min(
        sizes) <= 1
