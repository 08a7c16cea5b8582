"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

The kernels have a plain C interface (``ops/csrc/*.cu``), so the build needs
no PyTorch headers: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -shared -Xcompiler -fPIC`` (plus ``EXTRA_FLAGS`` per library) into
``njode_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and of every ``csrc/`` header it includes, so a changed source or header
rebuilds and an unchanged one loads the existing library. Nothing is built
or imported when this module is imported."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# per library: fused_scan.cu holds fifteen kernel instantiations, and
# -split-compile=0 runs its device optimisation passes on every host core,
# which halves its build on the H100 machine (24 to 12 s) and leaves its
# kernel times as they were; the GOB kernels built so measured up to 50 %
# slower in one run (PERF.md), so fused_gob.cu builds without it.
# -fmad=false: nvcc fuses no a * b + c the source does not write as fmaf,
# so the resident and the global plan, which compute each output with the
# same expressions in differently shaped code, round alike (fused where
# the surrounding code allowed it, the two plans' K2 parted by an ulp);
# likewise fused_gob.cu's shared and device-memory forms of the
# activations (with contraction, 36 of K5/K6's 43 outputs parted by an ulp
# at hidden 50; without it none, and K5 / K6 kept their times, PERF.md)
EXTRA_FLAGS = {"fused_scan": ("-split-compile=0", "-fmad=false"),
               "fused_gob": ("-fmad=false",)}

_lock = threading.Lock()
_loaded = {}
build_log = {}   # source name -> {"seconds", "ptxas", "path"}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with the "
        "CUDA toolkit (PATH or /usr/local/cuda/bin)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(src: str):
    """``src`` and every file it includes with ``#include "..."`` from
    ``csrc/``, transitively, in a fixed order."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc.decode())
                if os.path.exists(dep):
                    todo.append(dep)
    return seen


def source_digest(src: str) -> str:
    h = hashlib.sha256()
    for path in source_files(src):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _key(name, defines):
    return name + "".join("_" + d.lower() for d in defines)


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``, a
    library of its own) unless a library for the hash of it and its headers
    exists; returns the library path."""
    src = os.path.join(CSRC, name + ".cu")
    digest = source_digest(src)
    key = _key(name, defines)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{key}_{digest}.so")
    if os.path.exists(out):
        build_log.setdefault(key, {"seconds": 0.0, "ptxas": "",
                                   "path": out})
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", *EXTRA_FLAGS.get(name, ()),
           *("-D" + d for d in defines), "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    os.replace(tmp, out)
    build_log[key] = {"seconds": time.time() - t0, "ptxas": res.stderr,
                      "path": out}
    return out


def build_all(names) -> dict:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; returns {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load(name: str = "fused_scan", defines=()) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    key = _key(name, defines)
    with _lock:
        if key not in _loaded:
            lib = ctypes.CDLL(build(name, defines))
            _declare(name, lib)
            _loaded[key] = lib
        return _loaded[key]


def lib(name: str = "fused_scan") -> ctypes.CDLL:
    """The loaded library (its argument types declared), taking the build
    lock only on the first call: the wrappers' per-launch path."""
    got = _loaded.get(name)
    return got if got is not None else load(name)


def _declare(name, lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "fused_scan":
        lib.njode_error_string.argtypes = [I]
        lib.njode_error_string.restype = ctypes.c_char_p
        lib.njode_scan_fwd.argtypes = [P] * 19 + [I, F, P]
        lib.njode_scan_fwd.restype = I
        lib.njode_scan_bwd.argtypes = [P] * 21
        lib.njode_scan_bwd.restype = I
        lib.njode_scan_fwd_members.argtypes = [P, I] + [P] * 18 + [I, F, P]
        lib.njode_scan_fwd_members.restype = I
        lib.njode_scan_bwd_members.argtypes = [P, I] + [P] * 20
        lib.njode_scan_bwd_members.restype = I
        lib.njode_reduce_partials_members.argtypes = [P, I, I, I, F, P, P]
        lib.njode_reduce_partials_members.restype = I
        lib.njode_reduce_partials.argtypes = [P, I, I, F, P, P]
        lib.njode_reduce_partials.restype = I
        lib.njode_philox_masks.argtypes = [P, I, I, I, I, ctypes.c_uint32,
                                           P, P]
        lib.njode_philox_masks.restype = I
        lib.njode_scan_occupancy.argtypes = [P, I, P]
        lib.njode_scan_occupancy.restype = I
        lib.njode_phase_clock.argtypes = [P, P]
        lib.njode_phase_clock.restype = I
    elif name == "fused_gob":
        lib.gob_error_string.argtypes = [I]
        lib.gob_error_string.restype = ctypes.c_char_p
        lib.gob_scan_fwd.argtypes = [P] * 15 + [I, P, P]
        lib.gob_scan_fwd.restype = I
        lib.gob_scan_bwd.argtypes = [P] * 13 + [I, P, I, P, I] + [P] * 6
        lib.gob_scan_bwd.restype = I
        lib.gob_masks.argtypes = [P, I, I, I, ctypes.c_uint32, P, P]
        lib.gob_masks.restype = I
