"""The port imports neither jax nor the JAX package."""

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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "optax"
             or m == "njode_tpu" or m.startswith("njode_tpu."))
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
