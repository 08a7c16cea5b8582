"""The port's bench (``python -m njode_tpu_torch.bench``) against the repo's
``bench.py``: the same JSON keys, FLOP count and simulated paths, and no
run without a card unless the CPU is asked for."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

import bench as jbench
import torch_port_helpers as H
from njode_tpu_torch import bench as tbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keys(node_or_obj):
    """The nested key structure of a dict literal (AST) or a dict."""
    if isinstance(node_or_obj, ast.Dict):
        return {k.value: _keys(v) for k, v in zip(node_or_obj.keys,
                                                  node_or_obj.values)}
    if isinstance(node_or_obj, dict):
        return {k: _keys(v) for k, v in node_or_obj.items()}
    return None


def _bench_py_keys():
    """The keys of the object ``bench.py`` prints (its ``json.dumps``)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return _keys(node.args[0])
    raise AssertionError("no json.dumps of a dict literal in bench.py")


def test_bench_runs_small_on_the_cpu_with_bench_py_keys(capsys):
    """A tiny run on the CPU (the kernels' plain versions): the printed
    JSON line is the returned object, with exactly ``bench.py``'s keys, the
    epoch counts it was asked for and positive rates."""
    out = tbench.main(n_paths=40, batch_size=20, n_steps=6, device="cpu",
                      reps=2, chunk=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert "not a card" in lines[-2]
    assert _keys(out) == _bench_py_keys()
    assert out["epoch_chunk"] == 2
    assert out["per_epoch_dispatch"]["spread"]["n"] == 2
    assert len(out["per_epoch_dispatch"]["epoch_s"]) == 2
    for v in (out["value"], out["pipelined_paths_per_sec"],
              out["per_epoch_dispatch"]["paths_per_sec"]):
        assert v > 0
    assert out["flops_per_path"] == tbench.train_flops_per_path(
        tbench.bench_config(), 6)


def test_flops_per_path_matches_bench_py():
    """``train_flops_per_path`` equals ``bench.py``'s for the bench's
    configuration and for other widths (masked, input_current_t)."""
    from njode_tpu.models import njode as jnjode

    t = tbench.bench_config()
    j = jnjode.NJODEConfig(1, 10, 1, t.ode_nn, t.readout_nn, t.enc_nn,
                           dropout_rate=0.1)
    assert tbench.train_flops_per_path(t, 100) == \
        jbench.train_flops_per_path(j, 100) == 7_680_000
    for kw in (dict(masked=True), dict(input_current_t=True)):
        jcfg, tcfg = H.configs(3, 7, **kw)
        assert tbench.train_flops_per_path(tcfg, 15) == \
            jbench.train_flops_per_path(jcfg, 15)


def test_simulated_paths_equal_bench_py_bit_for_bit():
    a = tbench.simulate_bs_paths(50, 20, 0.05)
    b = jbench.simulate_bs_paths(50, 20, 0.05)
    assert a.dtype == b.dtype == np.float32 and a.shape == (50, 1, 21)
    assert np.array_equal(a, b)


def test_bench_without_a_card_raises():
    """``main()`` (the card) raises where there is none, and the CLI exits
    non-zero without a JSON line."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main(n_paths=40, batch_size=20, n_steps=6)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "njode_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
