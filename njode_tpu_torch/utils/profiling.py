"""Tracing, step timing and numerical-anomaly checks, the port's copy of
``njode_tpu/utils/profiling.py``:

- :func:`trace`: a ``torch.profiler`` capture around a block, written as a
  Chrome trace (``trace_<pid>_<n>.json``) into ``log_dir``; the trainer's
  ``profile_dir`` option traces its first epoch (the CUDA kernels appear
  under their names, ``njode_scan_fwd_kernel<...>`` and so on);
- :class:`StepTimer`: steps/s and items/s, synchronising the device in
  :meth:`StepTimer.stop` so a time covers the queued work;
- :func:`enable_anomaly_detection` / :func:`anomaly_detection`: torch's
  autograd anomaly mode (a backward that returns NaN raises, naming the
  forward operation) and, since torch has no switch for infinities, an
  explicit check of each training step's loss and gradients
  (:func:`check_step`) that raises FloatingPointError on a NaN and, with
  ``infs``, on an infinity.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

# (nans, infs) while anomaly detection is on, else None: read by
# check_step after every training step
_CHECK = None
_TRACES = itertools.count()
# launches, and the seconds they are spread over, that open a CUDA capture
# before the block (see trace)
_WARM_LAUNCHES = 256
_WARM_S = 0.1


def _sync(device=None):
    if torch.cuda.is_available() and (device is None
                                      or torch.device(device).type
                                      == "cuda"):
        torch.cuda.synchronize(device)


def _warm_up():
    x = torch.zeros(1, device="cuda")
    _sync()
    for _ in range(_WARM_LAUNCHES):
        x.add_(1.0)
        time.sleep(_WARM_S / _WARM_LAUNCHES)
    _sync()


@contextlib.contextmanager
def trace(log_dir=None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir`` (a
    no-op when None); yields the profiler (or None). CUDA activity is
    recorded where a card is present, and the device is synchronised
    before the capture ends.

    With a card, the capture opens with 256 one-element ``add_`` launches
    spread over a tenth of a second, then the block. Late in a long
    process on an H100, CUPTI lost the kernel records at the start of a
    capture now and then (their runtime launch records stayed): traces of
    the trainer's first epoch lacked the first step's K1, K2 and GEMMs (a
    tenth of a second of idle device before the block did not help), and
    3 of 280
    captures of 50 tiny kernels held none of them, while none of 120
    captures that opened with these launches lost any."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            _warm_up()
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(
        str(log_dir), f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def enable_anomaly_detection(nans: bool = True, infs: bool = False,
                             deterministic_seed=None):
    """Fail fast on non-finite values: torch's anomaly mode for NaNs in the
    backward, and :func:`check_step` after every training step (NaN, and
    with ``infs`` infinity, in the loss or a gradient raises
    FloatingPointError); ``deterministic_seed`` seeds numpy's and torch's
    global generators."""
    global _CHECK
    torch.autograd.set_detect_anomaly(bool(nans))
    _CHECK = (bool(nans), bool(infs)) if (nans or infs) else None
    if deterministic_seed is not None:
        import numpy as np
        np.random.seed(int(deterministic_seed))
        torch.manual_seed(int(deterministic_seed))


def disable_anomaly_detection():
    global _CHECK
    torch.autograd.set_detect_anomaly(False)
    _CHECK = None


@contextlib.contextmanager
def anomaly_detection(enabled: bool = True, **kw):
    """:func:`enable_anomaly_detection` for the block (nothing when not
    ``enabled``), the previous state restored after it."""
    global _CHECK
    if not enabled:
        yield
        return
    before = (torch.is_anomaly_enabled(), _CHECK)
    enable_anomaly_detection(**kw)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(before[0])
        _CHECK = before[1]


def check_step(loss, params):
    """Raise FloatingPointError if the step's loss or a gradient of
    ``params`` holds a NaN (or, with ``infs``, an infinity) while anomaly
    detection is on; a no-op otherwise. Reads one flag back from the
    device a step."""
    if _CHECK is None:
        return
    nans, infs = _CHECK
    tensors = [("loss", loss)] + [(f"gradient {i}", p.grad)
                                  for i, p in enumerate(params)
                                  if p.grad is not None]
    for name, t in tensors:
        t = t.detach()
        if (nans and bool(torch.isnan(t).any())) or \
                (infs and bool(torch.isinf(t).any())):
            raise FloatingPointError(
                f"anomaly detection: non-finite {name} after a training "
                "step")


class StepTimer:
    """Steps/s and items/s over a synchronised interval."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self.steps = 0
        self.items = 0

    def start(self):
        self._t0 = time.perf_counter()

    def step(self, n_items: int = 0):
        self.steps += 1
        self.items += n_items

    def stop(self, sync_on=None):
        """:param sync_on: a tensor or device to synchronise before reading
            the clock (a CUDA device: ``torch.cuda.synchronize``)."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        if sync_on is not None:
            _sync(sync_on.device if isinstance(sync_on, torch.Tensor)
                  else sync_on)
        elapsed = time.perf_counter() - self._t0
        return {
            "elapsed_s": elapsed,
            "steps_per_sec": self.steps / elapsed if elapsed > 0 else 0.0,
            "items_per_sec": self.items / elapsed if elapsed > 0 else 0.0,
        }
