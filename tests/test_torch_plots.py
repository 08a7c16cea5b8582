"""The port's path plots against the JAX package's: the arrays drawn by
``plot_one_path_with_pred``, the trainer's figure names and cadence (per
epoch, chunked and plot-only), and the trainer without matplotlib."""

import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

import matplotlib.axes

from njode_tpu.data import datasets as jdatasets
from njode_tpu.training import plots as jplots
from njode_tpu.training import trainer as jtrainer
from njode_tpu_torch.training import plots as tplots
from njode_tpu_torch.training import trainer as ttrainer

NN = ((8, "tanh"),)


@pytest.fixture
def drawn(monkeypatch):
    """Every array passed to ``Axes.plot``, ``scatter`` and
    ``fill_between`` (method name, positional arrays), in call order."""
    calls = []
    for meth in ("plot", "scatter", "fill_between"):
        orig = getattr(matplotlib.axes.Axes, meth)

        def rec(self, *args, _orig=orig, _meth=meth, **kw):
            calls.append((_meth, [np.array(a, dtype=np.float64)
                                  for a in args]))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(matplotlib.axes.Axes, meth, rec)
    return calls


def _same_drawing(a, b):
    assert [m for m, _ in a] == [m for m, _ in b]
    for (m, xs), (_, ys) in zip(a, b):
        assert len(xs) == len(ys), m
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("variance", [False, True])
def test_plot_arrays_match_jax(tmp_path, drawn, variance):
    """The same inputs give the same lines, dots and band (with the
    'power-2' moment's variance, clipped at 0 where negative) and the same
    file names."""
    rs = np.random.RandomState(0)
    B, D, K = 4, 2, 12
    paths = rs.lognormal(0, 0.3, (B, D, K + 1))
    obs = (rs.random((B, K + 1)) < 0.4).astype(np.int64)
    funcs = ["exp", "power-2"] if variance else None
    out_dim = D * (3 if variance else 1)
    pred_t = np.linspace(0, 1, K + 1)
    pred_y = rs.normal(1.0, 0.5, (K + 1, B, out_dim)).astype(np.float32)
    true_y = rs.normal(1.0, 0.5, (K + 1, B, out_dim)).astype(np.float32)
    files = []
    for i, mod in enumerate((jplots, tplots)):
        files.append(mod.plot_one_path_with_pred(
            None, pred_t, pred_y, pred_t, true_y, paths, obs, 1 / K, 1.0,
            path_to_plot=(0, 3), save_path=str(tmp_path / str(i)),
            filename="p-{}.png", plot_variance=variance, functions=funcs,
            std_factor=2, ylabels=["a", "b"]))
    n = len(drawn) // 2
    _same_drawing(drawn[:n], drawn[n:])
    assert sum(m == "fill_between" for m, _ in drawn[n:]) == (
        2 * D if variance else 0)
    assert [os.path.basename(f) for f in files[0]] == \
        [os.path.basename(f) for f in files[1]] == ["p-0.png", "p-3.png"]
    assert all(os.path.exists(f) for f in files[1])


def _dataset(base):
    hp = dict(jdatasets.hyperparam_default, nb_paths=50, nb_steps=10)
    jdatasets.create_dataset("BlackScholes", hp, seed=1, base_path=base)


KW = dict(epochs=4, batch_size=10, save_every=2, hidden_size=4,
          dropout_rate=0.0, ode_nn=NN, readout_nn=NN, enc_nn=NN,
          dataset="BlackScholes", plot=True, paths_to_plot=(0, 2))


def _plots(models, mid=1):
    return sorted(os.listdir(os.path.join(models, f"id-{mid}", "plots")))


def _data_lines(calls):
    """The drawn arrays that do not depend on the model: the true paths,
    their observed points and the true conditional expectation (every
    call but each figure's prediction line, the third)."""
    return [c for i, c in enumerate(calls) if i % 4 != 2]


def test_trainer_plots_as_the_jax_trainer(tmp_path, drawn):
    """plot=True writes ``id-<n>/plots/epoch-<e>_path-<i>.pdf`` on the
    save cadence, the JAX trainer's names; the data lines equal the JAX
    trainer's; with epoch_chunk=4 (one chunk) the figures are drawn from
    each epoch's snapshot and equal the per-epoch run's; plot_only writes
    ``demo-plot_epoch-<e>_path-<i>.pdf`` from the saved model."""
    base = str(tmp_path / "data")
    _dataset(base)
    want = [f"epoch-{e}_path-{i}.pdf" for e in (2, 4) for i in (0, 2)]
    runs = {}
    for tag, train, kw in (
            ("jax", jtrainer.train, {}),
            ("port", ttrainer.train, dict(device="cpu", use_pallas=True)),
            ("chunk", ttrainer.train, dict(device="cpu", epoch_chunk=4,
                                           use_pallas=True))):
        models = str(tmp_path / tag)
        start = len(drawn)
        assert train(saved_models_path=models, base_data_path=base,
                     **KW, **kw) == 0
        assert _plots(models) == want, tag
        runs[tag] = drawn[start:]
    _same_drawing(_data_lines(runs["jax"]), _data_lines(runs["port"]))
    _same_drawing(runs["chunk"], runs["port"])
    for tag, train, kw in (("jax", jtrainer.train, {}),
                           ("port", ttrainer.train, dict(device="cpu"))):
        models = str(tmp_path / tag)
        assert train(model_id=1, saved_models_path=models,
                     base_data_path=base, plot_only=True, **KW, **kw) == 0
        assert _plots(models) == sorted(
            want + ["demo-plot_epoch-4_path-0.pdf",
                    "demo-plot_epoch-4_path-2.pdf"]), tag


def test_gob_trainer_plots(tmp_path):
    """The GRU-ODE-Bayes trainer draws its predicted mean path too."""
    base = str(tmp_path / "data")
    _dataset(base)
    models = str(tmp_path / "gob")
    assert ttrainer.train(
        saved_models_path=models, base_data_path=base, device="cpu",
        other_model="GRU_ODE_Bayes", **dict(KW, epochs=2, hidden_size=6,
                                            ode_nn=None, readout_nn=None,
                                            enc_nn=None)) == 0
    assert _plots(models) == ["epoch-2_path-0.pdf", "epoch-2_path-2.pdf"]


def test_no_matplotlib_skips_figures(tmp_path, monkeypatch, capsys):
    """Where matplotlib cannot be imported (a GPU host without it), plot=True
    prints one line, trains, returns 0 and writes no figure; plot_only
    too."""
    base = str(tmp_path / "data")
    _dataset(base)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not tplots.have_matplotlib()
    models = str(tmp_path / "m")
    assert ttrainer.train(saved_models_path=models, base_data_path=base,
                          device="cpu", **KW) == 0
    out = capsys.readouterr().out
    assert out.count(ttrainer.PLOT_SKIPPED) == 1
    assert out.count("optimal eval-loss (with current weight=") == 2
    assert ttrainer.train(model_id=1, saved_models_path=models,
                          base_data_path=base, device="cpu", plot_only=True,
                          **KW) == 0
    assert ttrainer.PLOT_SKIPPED in capsys.readouterr().out
    assert not os.path.exists(os.path.join(models, "id-1", "plots")) or \
        not os.listdir(os.path.join(models, "id-1", "plots"))
    assert os.path.exists(os.path.join(models, "id-1", "metric_id-1.csv"))


def test_demo_plots_and_pretrained_ids_raise(monkeypatch):
    """The port's demo trains with plot=True, as the JAX demo does through
    its trainer's default; the pretrained ids are not ported, by design."""
    from njode_tpu_torch import demo
    from njode_tpu_torch.data import datasets as tdatasets

    seen = {}
    monkeypatch.setattr(tdatasets, "_get_time_id", lambda *a: 1)
    monkeypatch.setattr(ttrainer, "train", lambda **kw: seen.update(kw))
    assert demo.main(["--epochs=3", "--device=cpu"]) == 0
    assert seen["plot"] is True and seen["epochs"] == 3
    assert seen["save_every"] == 5 and seen["device"] == "cpu"
    with pytest.raises(NotImplementedError, match="Not ported, by design"):
        demo.main(["--model_id=1"])
