"""The CUDA source of the GRU-ODE-Bayes kernels (ops/csrc/fused_gob.cu) run
on the CPU: built with g++ through the stub header of
scripts/rehearse_fused_gob.py (a CTA as its threads, ``__syncthreads`` a
barrier, the warp intrinsics through per-warp buffers), driven through its
C interface with the wrappers' configuration. K5, its eval form and K6's
three stages (remat, chain, wgrad; the workspace buffer by buffer) against
the plain versions at one and two rows a CTA in both mask modes, on the
variants with dropout (scripts/rehearse_fused_gob.py); the device-memory
form of the activations against the shared form bit for bit and, at
p_hidden 4,000, against the plain versions; stage (b)'s mask
source, the saved post-dropout activation, against the formula it
replaces; and the standalone mask kernel's C call against the plain Philox.
This finds arithmetic, indexing and barrier faults of the source without a
card; what nvcc refuses shows only on the card."""

import ctypes
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture(scope="module")
def cpu_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source on the CPU")
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_gob as rg

    from njode_tpu_torch.ops import _build

    lib = ctypes.CDLL(rg.build(str(tmp_path_factory.mktemp("gob_cpu"))))
    _build._declare("fused_gob", lib)
    return lib


@pytest.mark.parametrize("mode", ["prng", "input"])
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("variant", ["impute_drop", "mid_full_impute_drop"])
def test_cuda_source_matches_plain(cpu_lib, variant, R, mode):
    """K5 (loss, histories), the eval form, K6's gradients and d(h0, m0,
    v0) and stage (a)'s and (b)'s workspace against the plain versions;
    the midpoint variant draws all three mask slots a step."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_gob as rg

    v = next(x for x in rg.VARIANTS if x[0] == variant)
    assert rg.rehearse(cpu_lib, *v, R, mode)


def test_device_memory_form_matches_shared_form(cpu_lib):
    """The device-memory form of the activations forced at one row (the
    P-wide buffers in each CTA's slab) against the plain versions and, bit
    for bit, against the shared form: K5, the eval form, K6's gradients,
    d(h0, m0, v0) and the workspace (the midpoint variant with impute and
    dropout; the script runs every variant so)."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_gob as rg

    v = next(x for x in rg.VARIANTS if x[0] == "mid_full_impute_drop")
    assert rg.rehearse_forms(cpu_lib, *v, "prng", 3)


def test_p_hidden_4000_in_the_device_memory_form(cpu_lib):
    """p_hidden 4,000 (one row overflows one CTA's shared memory): the rule
    takes the device-memory form, and K5, the eval form and K6 in chunks of
    two steps (the carries passed between them) match the plain
    versions."""
    sys.path.insert(0, SCRIPTS)
    import rehearse_fused_gob as rg

    v = next(x for x in rg.VARIANTS if x[0] == "p4000")
    assert rg.rehearse(cpu_lib, *v, 1, "input", 2)


def test_stage_b_mask_source_is_the_formula_it_replaces():
    """Stage (b) takes p_model's hidden delta as ``a != 0 ? s / keep : 0``
    on the post-dropout activation ``a = keep_bit ? fmax(pre, 0) / keep :
    0`` that stage (a) saved, where it drew the mask for ``pre > 0 ?
    (keep_bit ? s / keep : 0) : 0``: the same bits, with NaN, signed
    zeros, subnormals and infinities among pre and s."""
    gen = torch.Generator().manual_seed(3)
    special = torch.tensor([float("nan"), 0.0, -0.0, 1e-45, -1e-45, 1e-38,
                            float("inf"), -float("inf"), 3.0, -3.0])
    pre = torch.cat([special.repeat_interleave(len(special)),
                     torch.randn(4000, generator=gen)])
    s = torch.cat([special.repeat(len(special)),
                   torch.randn(4000, generator=gen) * 1e3])
    keep_bit = torch.rand(len(pre), generator=gen) < 0.7
    keep_bit[:200] = True
    keep = torch.tensor(0.9, dtype=torch.float32)
    zero = torch.zeros(())
    a = torch.where(keep_bit, torch.fmax(pre, zero) / keep, zero)
    before = torch.where(pre > 0, torch.where(keep_bit, s / keep, zero), zero)
    after = torch.where(a != 0, s / keep, zero)
    assert torch.equal(before.view(torch.int32), after.view(torch.int32))


@pytest.mark.parametrize("K,B,P", [(13, 27, 7), (7, 13, 32), (5, 9, 33),
                                   (5, 9, 50)])
def test_standalone_masks_match_plain(cpu_lib, K, B, P):
    """gob_masks (K7 written out: a Philox a quad, the rows striding over
    a grid held to eight blocks on the CPU build's one SM) equals
    gob_masks_plain bit for bit, at widths of a partial quad, one and two
    words, with an odd batch."""
    from njode_tpu_torch.ops import fused_gob as fg

    seed = 2 ** 40 + 17
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    out = torch.full((K, 3, B, P), -1, dtype=torch.int8)
    sd = torch.tensor([seed], dtype=torch.int64)
    assert cpu_lib.gob_masks(sd.data_ptr(), K, B, P, thresh, out.data_ptr(),
                             None) == 0
    want = fg.gob_masks_plain(seed, torch.arange(K), B, P, thresh)
    assert torch.equal(out, want.to(torch.int8))
