"""The CUDA source of the NJODE scan kernels (ops/csrc/fused_scan.cu) run
on the CPU: built with g++ through the stub header of
scripts/rehearse_fused_gob.py (a CTA as 256 threads, ``__syncthreads`` a
barrier), driven through its C interface with the wrappers'
configuration, K1, K2 and K3 of the resident plan against the plain
versions at one row a CTA (the rows rule's pick at the training batches)
and at 16 (the last CTA of the batch partly padding), and the global plan
at the same rows bit for bit (scripts/rehearse_fused_scan.py, a few of its
variants); 'prng' mode at 2 and 16 rows too, where the mask words of a
step take more lanes than the idle warps of its phases hold, and a net
37 columns wide (two words a row, a partial quad); and the standalone
mask kernel's C call against the plain Philox; and the full scope: an
output of another width than the input and nets of 9 to 33 linears (the
layer table in the kernels' device memory).
This finds arithmetic, indexing and barrier faults of the source without
a card; what nvcc refuses shows only on the card."""

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


@pytest.mark.parametrize("variant", ["out1_D2", "rnn_out2_D1", "deep16",
                                     "rnn_deep17"])
def test_full_scope_matches_plain_and_global_plan(cpu_lib, variant):
    """An unmasked output of another width than the input (the loss
    broadcast over the wider of the two, its gradient summed back; with
    the encoder and with the GRU jump; the global plan alone) and nets of
    16 and 17 linears (the ODE net's 17 beside a 4-linear readout, with
    the GRU jump; there the global plan bit for bit the resident plan):
    K1, K2 and K3 against the plain versions, at one row in 'prng' mode
    (the script's other full-scope variants, all three nets of 33
    linears among them, run on request)."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_scan as rs

    name, kw, D = next(v for v in rs.VARIANTS if v[0] == variant)
    assert rs.rehearse(cpu_lib, name, kw, D, 1, "prng")


@pytest.mark.parametrize("variant,R", [
    (v, R) for v in ("unmasked", "masked", "rnn_masked", "depths")
    for R in (2, 16)] + [("wide37", R) for R in (1, 2, 16)])
def test_prng_masks_at_more_rows(cpu_lib, variant, R):
    """'prng' mode at R rows a CTA: the mask words filled on the idle warps
    of a step's phases (at 16 rows most of them in its last phase) give
    the plain versions' results, and the global plan the same bits."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_scan as rs

    name, kw, D = next(v for v in rs.VARIANTS if v[0] == variant)
    assert rs.rehearse(cpu_lib, name, kw, D, R, "prng")


@pytest.mark.parametrize("K,S,B,W", [(11, 5, 21, 7), (7, 3, 13, 32),
                                     (4, 5, 9, 33), (4, 5, 9, 50)])
def test_standalone_masks_match_plain(cpu_lib, K, S, B, W):
    """njode_philox_masks (K4 written out: a Philox a quad, the rows
    striding over a grid held to eight blocks on the CPU build's one SM)
    equals philox_keep_plain bit for bit, at widths of a partial quad, one
    and two words, with odd S and B."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_scan as rs

    assert rs.masks(cpu_lib, K, S, B, W)


@pytest.mark.parametrize("variant,plan,R,mode", [
    ("unmasked", "resident", 1, "prng"), ("masked", "global", 2, "input"),
    ("rnn", "global", 1, "prng"), ("rnn_masked", "resident", 16, "input")])
def test_member_axis_matches_solo_calls(cpu_lib, variant, plan, R, mode):
    """K1, K2 and K3 over a member axis (E = 3 members of one config, each
    on its own weights, batch, masks and cotangent, one launch of grid
    (ceil(B/R), E)) give each member the bits of its own solo call, in
    both plans, masked or not, with the encoder or the GRU jump; the
    member reduce_partials gives its plain version's bits."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_scan as rs

    name, kw, D = next(v for v in rs.VARIANTS if v[0] == variant)
    assert rs.rehearse_members(cpu_lib, name, kw, D, R, mode, plan)
