"""Time the weight gradients' d^T x tile (njode_tpu_torch/ops/csrc/dtx.cuh,
stage (c) of the NJODE K2 and of the GRU-ODE-Bayes K6) at several thread
tiles and stage counts on one CUDA card.

    python3 scripts/tune_dtx.py

Each variant (outputs a thread DTX_TJ x DTX_TI, record blocks in flight
DTX_STAGES) is a small library of the two stage (c) kernels as
fused_scan.cu and fused_gob.cu define them, built with nvcc beside the
others into njode_tpu_torch/_build/dtx_tune/. Each is fed the tables and
a random workspace of one chunk at the NJODE main path (B = 200 and 100,
K = 100) and at GOB hidden 50 (B = 20, K = 100) and the climate GOB arm
(B = 100, K = 2,004). Prints the card's name and power limit, then a line
an arm: the device ms of one launch (one chunk; torch.profiler) of each
variant, twice in turn, marked ``!BITS`` where its partial rows differ
from the first variant's, and ``library``, the PyTorch calls of the same
jobs on the same chunk (``chip_smoke._wgrad_library``). Raises without a
card."""

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "njode_tpu_torch", "_build", "dtx_tune")
# (DTX_TI, DTX_TJ, DTX_STAGES); the first is the reference of the bits
VARIANTS = [(2, 4, 4), (4, 4, 4), (4, 2, 4), (2, 2, 4), (4, 1, 4),
            (4, 2, 3), (2, 2, 3), (4, 2, 6)]

LAUNCH = r'''
extern "C" int nj(const float* ws, int rec, int B, int steps, int Ks,
                  const int* tiles, const int* jobs, int n_tiles,
                  float* partials, int n_params, int n_str, void* st) {
  njode_wgrad_kernel<<<dim3(n_tiles * n_str, 1), DTX_NT, 0,
                       (cudaStream_t)st>>>(ws, rec, B, steps, Ks, 0, tiles,
                                           jobs, n_tiles, partials, n_params,
                                           n_str, 0);
  return (int)cudaGetLastError();
}
extern "C" int gb(const float* ws, int KBc, int nrows, const int* tiles,
                  int n_tiles, const int* jobs, int n_split, float* partials,
                  int n_params, void* st) {
  gob_wgrad_kernel<<<dim3(n_tiles, n_split), DTX_NT, 0, (cudaStream_t)st>>>(
      ws, KBc, nrows, tiles, jobs, n_split, partials, n_params, 0);
  return (int)cudaGetLastError();
}
'''


def kernel_text(src, name):
    """The definition of kernel ``name`` in csrc/``src``."""
    with open(os.path.join(CSRC, src)) as f:
        s = f.read()
    a = s.index(f"__global__ void __launch_bounds__(DTX_NT)\n{name}(")
    return s[a:s.index("\n}\n", a) + 3]


def build(v):
    """nvcc of one variant; returns (tag, library path, ptxas lines)."""
    from njode_tpu_torch.ops import _build

    ti, tj, st = v
    tag = f"v{ti}{tj}{st}"
    src = os.path.join(OUT, tag + ".cu")
    with open(src, "w") as f:
        f.write("#include <cuda_runtime.h>\n#include <stdint.h>\n"
                f"#define DTX_TI {ti}\n#define DTX_TJ {tj}\n"
                f"#define DTX_STAGES {st}\n"
                f'#include "{os.path.join(CSRC, "dtx.cuh")}"\n'
                + kernel_text("fused_scan.cu", "njode_wgrad_kernel")
                + kernel_text("fused_gob.cu", "gob_wgrad_kernel") + LAUNCH)
    lib = os.path.join(OUT, f"lib{tag}.so")
    r = subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", "-o", lib, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{r.stderr}")
    return tag, lib, [ln.strip() for ln in r.stderr.splitlines()
                      if "registers" in ln]


def arms(dev, stream):
    """[(name, partials, launch(lib), library yardstick)] at one chunk of
    each arm, on random workspaces."""
    import torch

    import chip_smoke as cs
    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs

    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for B in (200, 100):
        spec = fs.Spec(cs.main_path_setup(B, 100, 5, dev)[0], "prng")
        tiles, jobs = spec.wgrad_program(dev)
        Kc, Ks = spec.bwd_chunk(100, B), spec.wgrad_steps(B)
        n_str = -(-Kc // Ks)
        ws = torch.randn((Kc * B, spec.rec), generator=g, device=dev)
        part = torch.empty((n_str, spec.n_params), device=dev)

        def nj(lib, spec=spec, ws=ws, tiles=tiles, jobs=jobs, B=B, Kc=Kc,
               Ks=Ks, n_str=n_str, part=part):
            return lib.nj(ws.data_ptr(), spec.rec, B, Kc, Ks,
                          tiles.data_ptr(), jobs.data_ptr(), tiles.shape[0],
                          part.data_ptr(), spec.n_params, n_str, stream)

        out.append((f"nj_B{B}", part, nj, lambda spec=spec, ws=ws:
                    cs._wgrad_library(spec, lambda f: fs.ws_view(spec, ws, f),
                                      True)))
    gcfg, _ = cs._climate_gob(dev)
    for name, cfg, B, K in (
            ("gob_h50", cs.gob_setup(20, 100, 50, True, 1e-4, 50, dev)[0],
             20, 100),
            ("gob_clim", gcfg, 100, 2004)):
        spec = fg.Spec(cfg, "prng")
        Kc = spec.bwd_chunk(K, B)
        n_split = spec.wgrad_splits(Kc * B)
        tiles, jobs = spec.wgrad_program(dev)
        ws = torch.randn((Kc * B * spec.n_ws,), generator=g, device=dev)
        part = torch.empty((n_split, spec.n_params), device=dev)

        def gb(lib, spec=spec, ws=ws, tiles=tiles, jobs=jobs, KB=Kc * B,
               n_split=n_split, part=part):
            return lib.gb(ws.data_ptr(), KB, KB, tiles.data_ptr(),
                          tiles.shape[0], jobs.data_ptr(), n_split,
                          part.data_ptr(), spec.n_params, stream)

        out.append((name, part, gb, lambda spec=spec, ws=ws, KB=Kc * B:
                    cs._wgrad_library(
                        spec, lambda f: fg.ws_view(spec, ws, KB, f), False)))
    return out


def main():
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError("scripts/tune_dtx.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(build, VARIANTS))
    print("nvcc_s", round(time.time() - t0, 1), flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for tag, path, regs in built:
        lib = ctypes.CDLL(path)
        lib.nj.argtypes = [P, I, I, I, I, P, P, I, P, I, I, P]
        lib.gb.argtypes = [P, I, I, P, I, P, I, P, I, P]
        libs[tag] = lib
        print(tag, regs, flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, part, launch, library in arms(dev, stream):
        ref, line = None, [name]
        for _ in range(2):
            for tag, lib in libs.items():
                part.fill_(float("nan"))
                if launch(lib) != 0:
                    raise RuntimeError(f"{tag} failed to launch at {name}")
                torch.cuda.synchronize()
                ref = part.clone() if ref is None else ref
                same = torch.equal(part, ref)
                ms = cs.device_ms(lambda: launch(lib), "wgrad_kernel", 50)
                line.append(f"{tag}={ms or float('nan'):.5f}"
                            + ("" if same else "!BITS"))
        ms = cs.device_ms(library, None, 20)
        line.append(f"library={ms or float('nan'):.5f}")
        print(" ".join(line), flush=True)


if __name__ == "__main__":
    main()
