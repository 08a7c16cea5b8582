"""The port's grouped synthetic sweep (njode_tpu_torch/training/
group_sweep.py) against the JAX package's and against its own solo
trainer: the planners, the group key, a group against the same entries run
solo (metric rows and checkpoints bit for bit, on the eager route and on
the kernels' route, whose plain versions run on the CPU), padding batches,
``epoch_chunk``, a ragged tail, ``repeat_seed`` members, and one grouped
epoch against the JAX grouped ``train_epoch`` from the same weights."""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from njode_tpu.training import group_sweep as jgroup
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.training import group_sweep as tgroup
from njode_tpu_torch.training import sweeps as tsweeps
from njode_tpu_torch.utils.csv_frame import read_frame, to_float

SMALL_HP = dict(drift=2.0, volatility=0.3, mean=4, speed=2.0,
                correlation=0.5, nb_paths=60, nb_steps=12, S0=1,
                maturity=1.0, dimension=1, obs_perc=0.25,
                scheme="euler", return_vol=False, v0=1)
NN = ((8, "tanh"),)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("training_data_group"))
    tdatasets.create_dataset("BlackScholes", SMALL_HP, seed=1,
                             base_path=base, device="cpu")
    return base


def _param(seed=398, **kw):
    p = dict(epochs=2, batch_size=12, save_every=1, learning_rate=0.01,
             test_size=0.2, seed=seed, hidden_size=6, dropout_rate=0.1,
             ode_nn=NN, readout_nn=NN, enc_nn=NN, dataset="BlackScholes",
             plot=False, evaluate=True, device="cpu")
    p.update(kw)
    return p


def _rows(smp, mid):
    cols, rows = read_frame(os.path.join(smp, f"id-{mid}",
                                         f"metric_id-{mid}.csv"))
    keep = [i for i, c in enumerate(cols)
            if c not in ("train_time", "eval_time")]
    return [cols[i] for i in keep], np.array(
        [[to_float(r[i]) for i in keep] for r in rows])


def _tensors(obj, path=""):
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _tensors(obj[k], f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _tensors(v, f"{path}[{i}]")
    else:
        yield path, obj


def _ckpt(smp, mid, slot):
    return list(_tensors(torch.load(
        os.path.join(smp, f"id-{mid}", slot, "checkpt.tar"),
        map_location="cpu", weights_only=True)))


def _same_runs(smp_a, smp_b, mids):
    """Metric rows (but the times) and both checkpoint slots equal bit for
    bit."""
    for mid in mids:
        (ca, ra), (cb, rb) = _rows(smp_a, mid), _rows(smp_b, mid)
        assert ca == cb
        np.testing.assert_array_equal(ra, rb, err_msg=str(mid))
        for slot in ("last_checkpoint", "best_checkpoint"):
            a, b = _ckpt(smp_a, mid, slot), _ckpt(smp_b, mid, slot)
            assert [k for k, _ in a] == [k for k, _ in b]
            for (k, x), (_, y) in zip(a, b):
                same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                        else x == y)
                assert same, (mid, slot, k)


def test_planners_match_jax():
    """plan_groups and plan_compile_sharing give the JAX package's groups
    on the same param lists (the JAX tests' lists)."""
    params = [
        _param(seed=1), _param(seed=2), _param(seed=3),
        _param(seed=1, ode_nn=((24, "tanh"),)),
        _param(seed=1, dataset="climate"),
        _param(seed=1, other_model="GRU_ODE_Bayes"),
        _param(seed=1, func_appl_X=["power-2"]),
        _param(seed=1, resume_training=True),
    ]
    strip = [{k: v for k, v in p.items() if k != "device"} for p in params]
    assert tgroup.plan_groups(params) == jgroup.plan_groups(strip) == (
        [[0, 1, 2]], [3, 4, 5, 6, 7])
    ps = [_param(seed=s, training_size=ts)
          for ts in (240, 480) for s in (1, 2)]
    ps += [_param(seed=s, training_size=240, ode_nn=((24, "tanh"),))
           for s in (1, 2)]
    strip = [{k: v for k, v in p.items() if k != "device"} for p in ps]
    groups = tgroup.plan_groups(ps)[0]
    assert groups == jgroup.plan_groups(strip)[0]
    assert tgroup.plan_compile_sharing(ps, groups) == \
        jgroup.plan_compile_sharing(strip, groups)


def test_group_key_separates_every_option():
    base = _param()
    key = tgroup.group_key(base)
    assert key == tgroup.group_key(dict(base, seed=7, model_id=3,
                                        parallel=True, repeat_seed=2))
    for k, d in tgroup._MATCH_KEYS:
        other = dict(base, **{k: ((3, "relu"),) if k in tgroup._NN_KEYS
                              else ("changed", k)})
        assert tgroup.group_key(other) != key, k
    # the TPU-only keys the port's trainer ignores are inert
    assert tgroup.group_key(dict(base, use_orbax=True, orbax_async=True,
                                 pallas_interpret=True)) == key
    # options the grouped path does not implement: ungroupable
    for kw in (dict(ema_decay=0.99), dict(remat=True),
               dict(func_appl_X=["power-2"]), dict(plot_only=True)):
        assert tgroup.group_key(dict(base, **kw)) is None, kw


@pytest.mark.parametrize("route", [
    {}, dict(use_pallas=True), dict(use_pallas=True,
                                    pallas_mask_mode="input")],
    ids=["eager", "kernels_prng", "kernels_input"])
def test_group_matches_sequential_solo_runs(tiny_dataset, tmp_path, route):
    """Two same-width entries train as one group, the third (another
    width) solo in the same sweep; every member's metric rows and
    checkpoints are its solo run's, bit for bit."""
    def mk(smp):
        kw = dict(saved_models_path=smp, base_data_path=tiny_dataset,
                  **route)
        return [_param(seed=398, **kw), _param(seed=399, **kw),
                _param(seed=398, ode_nn=((10, "tanh"),), **kw)]

    smp_g, smp_s = str(tmp_path / "g") + os.sep, str(tmp_path / "s") + os.sep
    assert tsweeps.parallel_training(params=mk(smp_g), vmap_groups=True) \
        == [0, 0, 0]
    assert tsweeps.parallel_training(params=mk(smp_s)) == [0, 0, 0]
    _same_runs(smp_g, smp_s, (1, 2, 3))
    assert not np.array_equal(_rows(smp_g, 1)[1], _rows(smp_g, 2)[1])


def test_padding_batches_are_exact_noops(tiny_dataset, tmp_path):
    """pad_batches_to (the planner's compile sharing) changes nothing: the
    metric rows and checkpoints, Adam's step count included, are those of
    the unpadded group."""
    def run(tag, pad):
        smp = str(tmp_path / tag) + os.sep
        ps = [dict(_param(seed=s, saved_models_path=smp,
                          base_data_path=tiny_dataset, training_size=24),
                   model_id=i + 1, parallel=True)
              for i, s in enumerate((398, 399))]
        assert tgroup.train_group(ps, pad_batches_to=pad) == [0, 0]
        return smp

    a, b = run("nopad", None), run("pad", 7)
    _same_runs(a, b, (1, 2))
    steps = dict(_ckpt(b, 1, "last_checkpoint"))
    step_keys = [k for k in steps if k.endswith(".step")]
    assert step_keys and all(float(steps[k]) == 4.0 for k in step_keys)


def test_epoch_chunk_matches_per_epoch(tiny_dataset, tmp_path):
    def mk(smp, **kw):
        return [_param(seed=s, epochs=4, weight_decay=0.9,
                       saved_models_path=smp, base_data_path=tiny_dataset,
                       use_pallas=True, **kw) for s in (398, 399)]

    smp_c, smp_p = str(tmp_path / "c") + os.sep, str(tmp_path / "p") + os.sep
    assert tsweeps.parallel_training(params=mk(smp_c, epoch_chunk=3),
                                     vmap_groups=True) == [0, 0]
    assert tsweeps.parallel_training(params=mk(smp_p),
                                     vmap_groups=True) == [0, 0]
    _same_runs(smp_c, smp_p, (1, 2))
    assert _rows(smp_c, 1)[1][:, 0].tolist() == [1, 2, 3, 4]


def test_ragged_tail_and_repeat_seed_match_sequential(tiny_dataset,
                                                      tmp_path):
    """batch_size 9 over 48 training paths (5 batches and a tail of 3: the
    tail trains as one more member-axis step) and repeat_seed members (same
    split, their own streams) reproduce their solo runs."""
    def mk(smp):
        kw = dict(batch_size=9, saved_models_path=smp,
                  base_data_path=tiny_dataset, use_pallas=True)
        return [_param(seed=398, **kw), _param(seed=398, repeat_seed=1, **kw)]

    assert tgroup.plan_groups(mk("x")) == ([[0, 1]], [])
    smp_g, smp_s = str(tmp_path / "g") + os.sep, str(tmp_path / "s") + os.sep
    assert tsweeps.parallel_training(params=mk(smp_g), vmap_groups=True) \
        == [0, 0]
    assert tsweeps.parallel_training(params=mk(smp_s)) == [0, 0]
    _same_runs(smp_g, smp_s, (1, 2))
    (c, r1), (_, r2) = _rows(smp_g, 1), _rows(smp_g, 2)
    assert not np.array_equal(r1[:, c.index("train_loss")],
                              r2[:, c.index("train_loss")])
    np.testing.assert_array_equal(r1[:, c.index("optimal_eval_loss")],
                                  r2[:, c.index("optimal_eval_loss")])


def test_kernel_route_matches_eager_route(tiny_dataset, tmp_path):
    """The member-axis kernels' plain versions against the eager forward,
    same 'input' masks (drawn from the same generators), within the
    North-star tolerances over two epochs."""
    def mk(smp, **kw):
        return [_param(seed=s, saved_models_path=smp,
                       base_data_path=tiny_dataset, pallas_mask_mode="input",
                       **kw) for s in (398, 399)]

    smp_k, smp_e = str(tmp_path / "k") + os.sep, str(tmp_path / "e") + os.sep
    assert tsweeps.parallel_training(params=mk(smp_k, use_pallas=True),
                                     vmap_groups=True) == [0, 0]
    assert tsweeps.parallel_training(params=mk(smp_e, use_pallas=False),
                                     vmap_groups=True) == [0, 0]
    for mid in (1, 2):
        np.testing.assert_allclose(_rows(smp_k, mid)[1], _rows(smp_e, mid)[1],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "kernels"])
def test_group_epoch_matches_jax_grouped_epoch(use_kernels):
    """One grouped epoch of the port (dropout 0) against the JAX grouped
    ``train_epoch`` from the same stacked weights (carried across with
    ``jax_compat.state_dict_from_jax_params``) and the same index matrix.
    Member 1 sits out the last batch: the port leaves it out of that
    step's ``live`` members, the JAX epoch gives it batch scale 0
    (``jnp.where(live, new, old)``; the other members' reference is the
    epoch with every batch live). The live batches' losses, each member's
    weights and its Adam step count agree to the North-star tolerances."""
    import jax
    import jax.numpy as jnp
    import optax

    from njode_tpu.models import njode as jnjode
    from njode_tpu.training.steps import make_optimizer as jmake_optimizer
    from njode_tpu_torch.models import njode as tnjode
    from njode_tpu_torch.training import group_common
    from njode_tpu_torch.training.jax_compat import \
        state_dict_from_jax_params
    from njode_tpu_torch.training.steps import gather_dense_batch, \
        make_optimizer

    E, B, n, K, sitter = 3, 8, 3, 12, 1
    nn = ((9, "tanh"),)
    args = dict(input_size=1, hidden_size=5, output_size=1, ode_nn=nn,
                readout_nn=nn, enc_nn=nn, dropout_rate=0.0)
    jcfg, tcfg = jnjode.NJODEConfig(**args), tnjode.NJODEConfig(**args)
    rs = np.random.RandomState(0)
    paths = rs.lognormal(0, 0.3, (40, 1, K + 1)).astype(np.float32)
    obs = (rs.random((40, K + 1)) < 0.35).astype(np.float32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)
    idx = np.stack([rs.permutation(40)[:n * B].reshape(n, B)
                    for _ in range(E)]).astype(np.int32)
    jparams = [jnjode.init_params(jax.random.PRNGKey(10 + e), jcfg)
               for e in range(E)]

    fns = jgroup._make_group_step_fns(jcfg, 0.01, times, dts, None, False,
                                      None)
    keys = jnp.zeros((E, n, 2), jnp.uint32)
    ref = {}
    for tag, scales in (("all", [1.0] * n),
                        ("dead", [1.0] * (n - 1) + [0.0])):
        # the epoch donates its weights and optimizer state: fresh ones
        params_e = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
        opt_e = jax.vmap(jmake_optimizer(0.01).init)(params_e)
        ref[tag] = fns["train_epoch"](
            params_e, opt_e, jnp.asarray(paths), jnp.asarray(obs),
            jnp.asarray(idx), jnp.float32(0.5), keys,
            jnp.asarray(scales, jnp.float32))

    def adam_count(opt, e):
        st = [s for s in jax.tree_util.tree_leaves(
            opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        return int(st[0].count[e])

    models, opts = [], []
    for p in jparams:
        m = tnjode.NJODE(tcfg)
        m.load_state_dict(state_dict_from_jax_params(
            jax.tree.map(np.asarray, p)))
        models.append(m)
        opts.append(make_optimizer(m.parameters(), 0.01))
    step = group_common.make_group_step(models, opts, use_kernels)
    tt, td = torch.tensor(times), torch.tensor(dts)
    tp, to = torch.tensor(paths), torch.tensor(obs)
    for j in range(n):
        live = [e for e in range(E) if j < n - 1 or e != sitter]
        batches = [gather_dense_batch(tp, to, torch.tensor(
            idx[e, j].astype(np.int64)), tt, td) for e in live]
        tl = step(batches, 0.5, [torch.Generator().manual_seed(e)
                                 for e in live], live)
        for k, e in enumerate(live):
            want = ref["dead" if e == sitter else "all"][2]
            np.testing.assert_allclose(tl[k].item(), np.asarray(want)[j, e],
                                       rtol=1e-5, atol=1e-6)
    for e, (m, o) in enumerate(zip(models, opts)):
        p_after, o_after, _ = ref["dead" if e == sitter else "all"]
        want = state_dict_from_jax_params(
            jax.tree.map(lambda x: np.asarray(x[e]), p_after))
        for k, v in m.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        steps = {int(st["step"]) for st in o.state.values()}
        assert steps == {adam_count(o_after, e)} == {
            n - 1 if e == sitter else n}, e


def test_group_mesh_raises_naming_roadmap(tiny_dataset, tmp_path):
    ps = [dict(_param(seed=s, saved_models_path=str(tmp_path),
                      base_data_path=tiny_dataset), model_id=i + 1)
          for i, s in enumerate((1, 2))]
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tgroup.train_group(ps, mesh=object())


@pytest.mark.parametrize("name", ["base_synthetic", "convergence_study",
                                  "gru_ode_bayes_comparison",
                                  "climate_cross_validation",
                                  "physionet_comparison"])
def test_canonical_grids_plan_into_the_jax_groups(name):
    """Every published grid that needs no dataset made, after the
    registry's JSON round trip, plans into the JAX package's groups through
    the sweep's three planners in its order (synthetic, then PhysioNet
    among the leftovers, then climate); the climate CV into two 5-fold
    groups and the GRU-ODE-Bayes arm, the PhysioNet comparison into one
    group of repeats per width."""
    import json

    from njode_tpu.experiments import configs as jconfigs
    from njode_tpu.training import climate_group as jcg
    from njode_tpu.training import physionet_group as jpg
    from njode_tpu_torch.experiments import configs as tconfigs
    from njode_tpu_torch.training import climate_group as tcg
    from njode_tpu_torch.training import physionet_group as tpg

    def roundtrip(params):
        out = []
        for i, p in enumerate(params):
            q = json.loads(json.dumps(p, sort_keys=True, default=str))
            q.update(model_id=i + 1, resume_training=False, parallel=True,
                     saved_models_path="/tmp/x")
            out.append(q)
        return out

    def plan(params, group, phys, clim):
        groups, singles = group.plan_groups(params)
        out = [sorted(g) for g in groups]
        left = list(singles)
        for planner in (phys, clim):
            pg, rest = planner.plan_groups([params[i] for i in left])
            out += [sorted(left[i] for i in g) for g in pg]
            left = [left[i] for i in rest]
        return out, left

    kw = dict(epochs=3)
    if name == "physionet_comparison":
        kw["repeats"] = 3
    params = roundtrip(tconfigs.EXPERIMENTS[name](**kw)[0])
    jparams = roundtrip(jconfigs.EXPERIMENTS[name](**kw)[0])
    got = plan(params, tgroup, tpg, tcg)
    assert got == plan(jparams, jgroup, jpg, jcg)
    if name == "climate_cross_validation":
        assert got == ([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], [10])
    if name == "physionet_comparison":
        assert sorted(len(g) for g in got[0]) == [3, 3] and got[1] == []
