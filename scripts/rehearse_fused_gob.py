"""Rehearse the GRU-ODE-Bayes CUDA kernels (njode_tpu_torch/ops/csrc/
fused_gob.cu) on the CPU, before a card run.

    python scripts/rehearse_fused_gob.py [variant ...]

Compiles the source with g++ (C++20) through a small header that defines
the CUDA keywords away: each CTA runs as its ``std::thread``s in turn,
``__syncthreads`` is a ``std::barrier`` of the CTA, ``__shfl_xor_sync`` an
exchange through a per-warp buffer between two barriers of the warp,
``__reduce_or_sync`` over one aligned group of eight lanes (the mask words'
lanes) the same through a barrier of the group, the dynamic shared memory
a global array filled with NaN before each CTA, and every
``kernel<<<grid, block, smem, stream>>>(args)`` a loop over the grid (each
CTA ``block`` threads, one- or two-dimensional).
Then it drives the C interface with the configuration the wrappers build
(``fused_gob.make_cfg``, ``Spec.wgrad_program``) on CPU tensors, at
several rows per CTA and chunk lengths, in both mask modes, in the
device-memory form of the activations (forced, bit for bit against the
shared form, and at p_hidden 4,000 where the rule takes it), and prints
each kernel's distance from its plain version: K5's loss and histories,
the eval loss, K6's gradients and d(h0, m0, v0), and stage (a)'s and (b)'s
workspace buffer by buffer against ``gob_scan_bwd_staged_plain``. It finds
arithmetic, indexing and barrier faults (a mismatched barrier hangs), not
what nvcc refuses. Small shapes only: a CTA costs 256 thread starts.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STUB = r'''
#pragma once
#include <cstddef>
#include <cstdint>
#include <cmath>
#include <math.h>
#include <cstring>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
#include <limits>
#include <cstdlib>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local int g_lin;              // the thread's linear index
inline dim3 blockDim(256), gridDim;
inline std::barrier<>* g_block_bar;
inline std::barrier<>* g_warp_bar[32];
inline std::barrier<>* g_group_bar[32][4];
inline float g_shfl[32][32];
inline unsigned g_red[32][32];
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int w) {
  int warp = g_lin >> 5, lane = g_lin & 31;
  g_shfl[warp][lane] = v;
  g_warp_bar[warp]->arrive_and_wait();
  float r = g_shfl[warp][lane ^ w];
  g_warp_bar[warp]->arrive_and_wait();
  return r;
}

inline unsigned __reduce_or_sync(unsigned mask, unsigned v) {
  int warp = g_lin >> 5, lane = g_lin & 31, g = lane >> 3;
  if (mask != (0xFFu << (8 * g))) std::abort();   // one group of eight
  g_red[warp][lane] = v;
  g_group_bar[warp][g]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 8; ++i) r |= g_red[warp][8 * g + i];
  g_group_bar[warp][g]->arrive_and_wait();
  return r;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __trap() { std::abort(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32); }
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
#define __align__(n) __attribute__((aligned(n)))
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1; return 0; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F*, int, int) {
  return 0; }
template <class F> inline cudaError_t
cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int, size_t) {
  *n = 0; return 0; }
extern float sm[];
template <class F> void launch_grid(dim3 g, dim3 b, size_t smem_bytes,
                                   F f) {
  gridDim = g;
  blockDim = b;
  const int threads = (int)(b.x * b.y * b.z);
  const int nw = threads / 32;
  std::barrier<> bb(threads);
  std::barrier<>* wb[32];
  std::barrier<>* gb[32][4];
  for (int w = 0; w < nw; ++w) {
    wb[w] = new std::barrier<>(32);
    for (int q = 0; q < 4; ++q) gb[w][q] = new std::barrier<>(8);
  }
  g_block_bar = &bb;
  for (int w = 0; w < nw; ++w) {
    g_warp_bar[w] = wb[w];
    for (int q = 0; q < 4; ++q) g_group_bar[w][q] = gb[w][q];
  }
  for (unsigned by = 0; by < g.y; ++by)
    for (unsigned bx = 0; bx < g.x; ++bx) {
      for (size_t i = 0; i < smem_bytes / 4; ++i)
        sm[i] = std::numeric_limits<float>::quiet_NaN();
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t, bx, by] {
          g_lin = t;
          threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
          blockIdx = dim3(bx, by); f(); });
      for (auto& th : ts) th.join();
    }
  for (int w = 0; w < nw; ++w) {
    delete wb[w];
    for (int q = 0; q < 4; ++q) delete gb[w][q];
  }
}
'''


def build(out_dir, name="fused_gob"):
    """The CPU library of csrc/<name>.cu in ``out_dir`` (fused_gob.cu, or
    fused_scan.cu for scripts/rehearse_fused_scan.py)."""
    csrc = os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc")
    with open(os.path.join(csrc, name + ".cu")) as f:
        s = f.read()
    s = s.replace("#include <cuda_runtime.h>",
                  '#include "cuda_stub.h"\nfloat sm[1 << 18];')
    for inc in re.findall(r'#include "(\w+\.cuh)"', s):
        with open(os.path.join(csrc, inc)) as f:
            s = s.replace(f'#include "{inc}"',
                          f.read().replace("#pragma once", ""))
    s = s.replace("extern __shared__ float sm[];", "")

    def launch(m):
        name, cfg, args = m.group(1), m.group(2), m.group(3)
        parts = [p.strip() for p in re.split(r",(?![^()]*\))", cfg)]
        smem = parts[2] if len(parts) > 2 else "0"
        return (f"launch_grid(dim3({parts[0]}), {parts[1]}, {smem}, "
                f"[&]() {{ {name}({args}); }});")

    s = re.sub(r"([\w]+(?:<[^<>;]*?>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", launch,
               s, flags=re.S)
    with open(os.path.join(out_dir, "cuda_stub.h"), "w") as f:
        f.write(STUB)
    src = os.path.join(out_dir, name + "_cpu.cpp")
    with open(src, "w") as f:
        f.write(s)
    lib = os.path.join(out_dir, f"lib{name}_cpu.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-Wno-unknown-pragmas", "-o", lib, src, "-lpthread"],
                   check=True)
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _setup(kw, D, Hd, B, K, pad, seed=0):
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    args = dict(input_size=D, hidden_size=Hd, p_hidden=Hd if Hd > 9 else 7,
                prep_hidden=Hd if Hd > 9 else 5, cov_size=D,
                cov_hidden=Hd if Hd > 9 else 6, mixing=1e-2)
    args.update(kw)
    cfg = gob.GOBConfig(**args)
    model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
    if not cfg.logvar:
        with torch.no_grad():
            model.p_model[3].bias[D:] += 1.0
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0.0, 0.3, size=(B, D, K + 1))
    observed = (rs.random((B, K + 1)) < 0.3).astype(np.int64)
    b = grid.recompute_n_obs(grid.batch_from_paths(paths, observed, 1.0 / K))
    m = (rs.random(b.M.shape) < 0.7).astype(np.float32)
    m[..., 0] = 1.0
    M = m * b.obs[:, :, None]
    f32 = np.float32
    b = b._replace(
        times=np.concatenate([b.times, np.ones(pad)]).astype(f32),
        dt=np.concatenate([b.dt, np.zeros(pad)]).astype(f32),
        obs=np.concatenate([b.obs, np.zeros((pad, B))]).astype(f32),
        X=np.concatenate([b.X * M, np.zeros((pad, B, D))]).astype(f32),
        M=np.concatenate([M, np.zeros((pad, B, D))]).astype(f32))
    batch = grid.to_torch(b, "cpu")
    arrays = tuple(t.contiguous() for t in (batch.times, batch.dt, batch.obs,
                                            batch.X, batch.M))
    leaves = [p.detach().contiguous()
              for p in fg.flat_leaves(model, fg.Spec(cfg))]
    with torch.no_grad():
        h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
        p0 = gob.mlp2(model.p_model, h0, 0.0)
    return cfg, arrays, leaves, (h0.contiguous(), p0[:, :D].contiguous(),
                                 p0[:, D:].contiguous())


def _slabs(cfg, B, Kc=1):
    """The device-memory form's slab buffer of a call (None in the shared
    form): K5's, or stage (a)'s and the chain's at chunk Kc."""
    import torch

    if not cfg.ga:
        return None
    nb = -(-B // cfg.rows)
    return torch.full((max(nb * Kc * cfg.slab_fwd, nb * cfg.slab_floats),),
                      float("nan"))


def rehearse(lib, name, kw, D, Hd, B, K, pad, R, mode, chunk=None,
             weights=None, threads=None, acts=None, want=False):
    """One configuration through the CPU build against the plain versions;
    prints one line and returns whether every distance is small (with
    ``want``, also the outputs: K5's loss and histories, the eval loss,
    K6's gradients and d(h0, m0, v0))."""
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    cfg, arrays, leaves, (h0, m0, v0) = _setup(kw, D, Hd, B, K, pad)
    spec = fg.Spec(cfg, mode, rows=R, weights=weights, acts=acts)
    K, B = arrays[2].shape
    u = seed = None
    if spec.dropping(True):
        if mode == "input":
            u = (torch.rand((K, 3, B, spec.P), generator=torch.Generator()
                            .manual_seed(1)) < 0.9).to(torch.int8)
        else:
            seed = torch.tensor([123456789012345], dtype=torch.int64)
    lp_ = (ctypes.c_void_p * len(leaves))(*[p.data_ptr() for p in leaves])
    times, dts, obs, X, M = arrays
    c = fg.make_cfg(spec, K, B, True)
    cb = fg.make_cfg(spec, K, B, True, chain=True)
    if threads is not None:      # the other CTA width than the rule's
        c.threads = cb.threads = threads
    part = torch.empty(-(-B // R))
    slab = _slabs(c, B)
    hists = (torch.empty(K, B, spec.H), torch.empty(K, B, spec.D),
             torch.empty(K, B, spec.D))
    assert lib.gob_scan_fwd(ctypes.addressof(c), lp_, _ptr(dts), _ptr(obs),
                            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(h0),
                            _ptr(m0), _ptr(v0), _ptr(part),
                            *(_ptr(t) for t in hists), 1, _ptr(slab),
                            None) == 0
    lp, hp = fg.gob_scan_fwd_plain(spec, leaves, arrays, h0, m0, v0, True,
                                   u, seed)
    e_l = abs(float(part.sum()) - float(lp)) / max(1.0, abs(float(lp)))
    e_h = max(float((a - b).abs().max()) for a, b in zip(hists, hp))
    ce = fg.make_cfg(spec, K, B, False, bwd=False)
    part_e = torch.empty(-(-B // ce.rows))
    slab = _slabs(ce, B)
    assert lib.gob_scan_fwd(ctypes.addressof(ce), lp_, _ptr(dts), _ptr(obs),
                            _ptr(X), _ptr(M), None, None, _ptr(h0), _ptr(m0),
                            _ptr(v0), _ptr(part_e), None, None, None, 0,
                            _ptr(slab), None) == 0
    le, _ = fg.gob_scan_fwd_plain(spec, leaves, arrays, h0, m0, v0, False,
                                  want_hists=False)
    e_e = abs(float(part_e.sum()) - float(le)) / max(1.0, abs(float(le)))
    Kc = chunk or spec.bwd_chunk(K, B)
    n_split = spec.wgrad_splits(Kc * B)
    tiles, jobs = spec.wgrad_program("cpu")
    ws = torch.full((Kc * B * spec.n_ws,), float("nan"))
    parts = torch.full((n_split, spec.n_params), float("nan"))
    d0 = (torch.empty(B, spec.H), torch.empty(B, spec.D),
          torch.empty(B, spec.D))
    dloss = torch.tensor([1.3])
    slab = _slabs(cb, B, Kc)
    assert lib.gob_scan_bwd(ctypes.addressof(cb), lp_, _ptr(dts), _ptr(obs),
                            _ptr(X), _ptr(M), _ptr(u), _ptr(seed),
                            *(_ptr(t) for t in hists), _ptr(dloss), _ptr(ws),
                            Kc, _ptr(tiles), tiles.shape[0], _ptr(jobs),
                            n_split, _ptr(parts), *(_ptr(t) for t in d0),
                            _ptr(slab), None) == 0
    flat = fg.fs.reduce_partials_plain(parts)
    gk = [flat[a:b].view(s) for a, b, s in
          zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    sp = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hists, 1.3,
                                      u, seed, chunk=Kc, want_ws=True)
    ref = fg.gob_scan_bwd_plain(spec, leaves, arrays, True, hists,
                                torch.tensor(1.3), u, seed)
    gmax = max(float(g.abs().max()) for g in ref[0])
    e_g = max(float((a - b).abs().max())
              for a, b in zip(gk, ref[0])) / max(1.0, gmax)
    e_d = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
              for a, b in zip(d0, ref[1:]))
    n = min(K, Kc) * B
    bad = {}
    for nm in fg.SAVED + tuple(d for d, _ in spec.deltas):
        a = fg.ws_view(spec, ws, Kc * B, nm)[:n]
        b = fg.ws_view(spec, sp[4], Kc * B, nm)[:n]
        e = float((a - b).abs().max() / max(1.0, float(b.abs().max())))
        if not e < 1e-4:
            bad[nm] = e
    ok = (e_l < 1e-5 and e_h < 1e-4 and e_e < 1e-5 and e_g < 1e-4
          and e_d < 1e-4 and not bad)
    print(f"{'ok ' if ok else 'BAD'} {name} R={R} {mode} chunk={Kc} "
          f"weights={'shared' if c.wsm else 'global'} threads={c.threads} "
          f"acts={'global' if c.ga else 'shared'} "
          f"loss {e_l:.1e} hist {e_h:.1e} eval {e_e:.1e} grad {e_g:.1e} "
          f"d0 {e_d:.1e} workspace {bad or 'ok'}", flush=True)
    if want:
        return ok, [part.sum(), *hists, part_e.sum(), *gk, *d0, ws]
    return ok


VARIANTS = [
    ("minimal", dict(), 2, 9, 5, 6, 2),
    ("impute", dict(impute=True), 2, 9, 5, 6, 2),
    ("full", dict(full_gru_ode=True), 2, 9, 5, 6, 2),
    ("full_impute", dict(full_gru_ode=True, impute=True), 2, 9, 5, 6, 2),
    ("absvar_impute", dict(logvar=False, impute=True), 2, 9, 5, 6, 2),
    ("mid_impute", dict(solver="midpoint", impute=True), 2, 9, 5, 6, 2),
    ("mid", dict(solver="midpoint"), 2, 9, 5, 6, 2),
    ("mid_full_impute_drop", dict(solver="midpoint", full_gru_ode=True,
                                  impute=True, dropout_rate=0.1),
     2, 9, 5, 6, 2),
    ("disc_impute", dict(discretized=True, impute=True), 2, 9, 5, 6, 2),
    ("disc", dict(discretized=True), 2, 9, 5, 6, 2),
    ("impute_drop", dict(impute=True, dropout_rate=0.1), 2, 9, 5, 6, 2),
    ("full_absvar", dict(full_gru_ode=True, logvar=False), 2, 9, 5, 6, 2),
    ("nobias_impute", dict(bias=False, impute=True), 2, 9, 5, 6, 2),
    ("climate_widths", dict(full_gru_ode=True, p_hidden=25, prep_hidden=10,
                            cov_hidden=50, mixing=1e-4, dropout_rate=0.2),
     5, 50, 5, 6, 2),
    # p_hidden 4,000: one row overflows one CTA's shared memory, so the
    # rule takes the device-memory form (the P-wide buffers in the slab)
    ("p4000", dict(impute=True, full_gru_ode=True, p_hidden=4000,
                   prep_hidden=10, cov_hidden=10, mixing=1e-4,
                   dropout_rate=0.1), 1, 10, 2, 3, 1),
]


def rehearse_forms(lib, name, kw, D, Hd, B, K, pad, mode, chunk=None):
    """The device-memory form forced against the shared form at one row,
    the weights in device memory in both (K5, the eval form and K6's
    stages): every output and the workspace bit for bit. Prints one line
    and returns whether they are equal."""
    import torch

    outs = [rehearse(lib, name, kw, D, Hd, B, K, pad, 1, mode, chunk,
                     "global", None, acts, want=True)
            for acts in ("shared", "global")]
    n_diff = sum(not torch.equal(a, b) for a, b in zip(outs[0][1],
                                                      outs[1][1]))
    ok = outs[0][0] and outs[1][0] and n_diff == 0
    print(f"{'ok ' if ok else 'BAD'} {name} device-memory form vs shared "
          f"form: outputs differing {n_diff}", flush=True)
    return ok


def main(names):
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(build(tmp))
        lib.gob_scan_fwd.argtypes = [P] * 15 + [I, P, P]
        lib.gob_scan_bwd.argtypes = [P] * 13 + [I, P, I, P, I] + [P] * 6
        ok = True
        for v in VARIANTS:
            if names and v[0] not in names:
                continue
            if v[0] == "p4000":          # the rule's device-memory form
                for mode, chunk in (("prng", None), ("input", 2)):
                    ok &= rehearse(lib, *v, 1, mode, chunk)
                continue
            for R, mode, chunk, w, t in ((1, "input", None, "shared", 512),
                                         (2, "prng", 3, "global", 256),
                                         (4, "input", 2, None, None)):
                ok &= rehearse(lib, *v, R, mode, chunk, w, t)
            ok &= rehearse_forms(lib, *v, "prng", 3)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
