"""ctypes bindings of the native collation (``collate.cc``): the union grid
(``njode_build_union_grid``) and the dense scatters of events
(``njode_densify_events``) and of grid-sampled paths
(``njode_densify_paths``).

The library is built with ``g++ -O3`` at first use into
``njode_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
and loaded once per process; nothing is built when this module is
imported. A failed build raises with g++'s stderr. The plain versions are
the numpy paths of ``data/grid.py`` (``build_union_grid`` and the scatters
inside ``batch_from_events`` and ``batch_from_paths``): the functions here
give their bits, and nothing in the port calls them in their place."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "collate.cc")
_lock = threading.Lock()
_lib = None

_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def build() -> str:
    """Compile ``collate.cc`` unless a library for its hash exists; returns
    the library path. Raises RuntimeError with g++'s stderr on failure."""
    from njode_tpu_torch.ops._build import BUILD_DIR, source_digest

    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR,
                       f"libnjode_collate_{source_digest(_SRC)}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not be run for {_SRC}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library (built if needed), its argument types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.njode_build_union_grid.restype = ctypes.c_int64
            lib.njode_build_union_grid.argtypes = [
                _f64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                ctypes.c_int64, _f64, _f64, _i64]
            lib.njode_densify_events.restype = None
            lib.njode_densify_events.argtypes = [
                _i64, _i64, _i64, _f32, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, _f32, _f32, _f32]
            lib.njode_densify_paths.restype = None
            lib.njode_densify_paths.argtypes = [
                _f64, _i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _f32, _f32, _f32, _f32]
            _lib = lib
        return _lib


def build_union_grid(obs_times, delta_t, T, max_steps):
    """The union grid padded to ``max_steps``: ``(times, dts, obs_step,
    K)``. A grid that needs more than ``max_steps`` steps raises the
    ValueError of ``grid.build_union_grid``, which is run to count them."""
    lib = get_lib()
    obs_times = np.ascontiguousarray(obs_times, np.float64)
    times = np.empty(max_steps, np.float64)
    dts = np.empty(max_steps, np.float64)
    obs_step = np.empty(len(obs_times), np.int64)
    k = lib.njode_build_union_grid(obs_times, len(obs_times), float(delta_t),
                                   float(T), max_steps, times, dts, obs_step)
    if k < 0:
        from njode_tpu_torch.data import grid
        grid.build_union_grid(obs_times, delta_t, T, max_steps)
        raise AssertionError("the numpy grid fits where the C++ grid "
                             "overflowed")
    return times, dts, obs_step, int(k)


def densify_events(obs_step, time_ptr, obs_idx, X, M, K, B):
    """The events scattered onto the grid: ``(obs [K,B], X [K,B,D], M
    [K,B,D])``; a later event of a (step, row) overwrites an earlier one,
    M = 1 at observed rows when None."""
    lib = get_lib()
    D = X.shape[1]
    out_obs = np.zeros((K, B), np.float32)
    out_X = np.zeros((K, B, D), np.float32)
    out_M = np.zeros((K, B, D), np.float32)
    X = np.ascontiguousarray(X, np.float32)
    m_ptr = None
    if M is not None:
        M = np.ascontiguousarray(M, np.float32)
        m_ptr = M.ctypes.data_as(ctypes.c_void_p)
    lib.njode_densify_events(
        np.ascontiguousarray(obs_step, np.int64),
        np.ascontiguousarray(time_ptr, np.int64),
        np.ascontiguousarray(obs_idx, np.int64),
        X, m_ptr, len(obs_step), B, D, out_obs, out_X, out_M)
    return out_obs, out_X, out_M


def densify_paths(paths, observed):
    """The dense batch of grid-sampled paths ``[B, D, T+1]``: ``(obs [K,B],
    X [K,B,D] (masked), M [K,B,D], n_obs [B])``, K = T."""
    lib = get_lib()
    paths = np.ascontiguousarray(paths, np.float64)
    observed = np.ascontiguousarray(observed, np.int64)
    B, D, T1 = paths.shape
    K = T1 - 1
    out_obs = np.empty((K, B), np.float32)
    out_X = np.empty((K, B, D), np.float32)
    out_M = np.empty((K, B, D), np.float32)
    out_n = np.empty(B, np.float32)
    lib.njode_densify_paths(paths, observed, B, D, T1, out_obs, out_X,
                            out_M, out_n)
    return out_obs, out_X, out_M, out_n
