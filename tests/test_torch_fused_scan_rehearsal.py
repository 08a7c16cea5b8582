"""The CUDA source of the NJODE scan kernels (ops/csrc/fused_scan.cu) run
on the CPU: built with g++ through the stub header of
scripts/rehearse_fused_gob.py (a CTA as 256 threads, ``__syncthreads`` a
barrier), driven through its C interface with the wrappers'
configuration, K1, K2 and K3 of the resident plan against the plain
versions at one row a CTA (the rows rule's pick at the training batches)
and at 16 (the last CTA of the batch partly padding), and the global plan
at the same rows bit for bit (scripts/rehearse_fused_scan.py, a few of its
variants). This finds arithmetic, indexing and barrier faults of the
source without a card; what nvcc refuses shows only on the card."""

import ctypes
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture(scope="module")
def cpu_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source on the CPU")
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_gob as rg

    from njode_tpu_torch.ops import _build

    lib = ctypes.CDLL(rg.build(str(tmp_path_factory.mktemp("scan_cpu")),
                               "fused_scan"))
    _build._declare("fused_scan", lib)
    return lib


@pytest.mark.parametrize("variant", ["unmasked", "masked", "rnn_masked",
                                     "depths"])
def test_cuda_source_matches_plain_and_global_plan(cpu_lib, variant):
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_scan as rs

    name, kw, D = next(v for v in rs.VARIANTS if v[0] == variant)
    for R, mode in ((1, "prng"), (16, "input")):
        assert rs.rehearse(cpu_lib, name, kw, D, R, mode)
