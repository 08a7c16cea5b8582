"""The port imports neither jax nor the JAX package, nor the packages the
card machine lacks (pandas, sklearn, matplotlib)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import njode_tpu_torch
names = [m.name for m in pkgutil.walk_packages(njode_tpu_torch.__path__,
                                               "njode_tpu_torch.")]
for n in names:
    importlib.import_module(n)
banned = ("jax", "optax", "njode_tpu", "pandas", "sklearn", "matplotlib")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1) if " " in out.stdout.strip() \
        else (out.stdout.strip(), "")
    assert int(n) >= 15, out.stdout
    assert bad == "", f"the port imported {bad}"


BANNED = {"jax", "optax", "njode_tpu", "pandas", "sklearn", "matplotlib"}


def _imported_modules(path):
    """The top-level names of every module a script imports."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    return mods


def test_ab_script_imports_no_jax():
    """``ab_scan_kernels.py`` runs on the card machine too."""
    mods = _imported_modules(os.path.join(ROOT, "ab_scan_kernels.py"))
    assert "njode_tpu_torch" in mods and not mods & BANNED, mods


def test_chip_smoke_imports_no_jax_and_needs_a_card(tmp_path):
    """``chip_smoke.py`` imports none of the banned packages, and exits
    non-zero with no result line where there is no CUDA card, and where
    the port is not beside it."""
    import shutil

    src = os.path.join(ROOT, "chip_smoke.py")
    mods = _imported_modules(src)
    assert not mods & BANNED, mods & BANNED
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(src, alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, src), (str(tmp_path), str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok": true' not in out.stdout


_PARALLEL = r"""
import sys
import njode_tpu_torch.parallel.sharding, njode_tpu_torch.parallel.multihost
sys.path.insert(0, "tests")
import torch_parallel_ranks
banned = ("jax", "optax", "njode_tpu", "pandas", "sklearn", "matplotlib")
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] in banned)))
"""


def test_parallel_modules_and_rank_functions_import_no_jax():
    """``parallel/sharding.py`` and ``parallel/multihost.py``, and the rank
    functions that ``sharding.spawn`` runs in the processes of the
    data-parallel tests (``tests/torch_parallel_ranks.py``), import none
    of the banned packages: a rank starts without JAX, as on the card
    machine, which has none."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported {out.stdout.strip()}"
    mods = _imported_modules(os.path.join(ROOT, "tests",
                                          "torch_parallel_ranks.py"))
    assert "njode_tpu_torch" in mods and not mods & BANNED, mods
