"""Tracing, step timing and NaN checks (port of
vtaco_tpu/utils/profiling.py:29-95 on torch.profiler).

  * ``trace(log_dir)``: a torch.profiler trace of the block (the host's
    operations, and the card's kernels where there is one), written to
    ``log_dir`` as a Chrome trace (chrome://tracing, Perfetto).
  * ``annotate(name)``: a named region in such a trace.
  * ``debug_nans(enable)``: autograd's anomaly mode for the block
    (torch.autograd.set_detect_anomaly), the counterpart of JAX's
    ``jax_debug_nans``; ``check_finite`` stops a run at the first step
    whose loss is not finite.
  * ``StepTimer``: rolling steps per second for the train loop's prints.
  * ``ProfiledRegion``: the loop's ``training.profile_dir`` trace of steps
    ``start_step`` to ``stop_step``.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import torch


def _profile():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _profile()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region visible in traces."""
    return torch.profiler.record_function(name)


def debug_nans(enable: bool = True):
    """A context under which autograd checks every backward function's
    output for NaN and raises at the operation that made it."""
    return torch.autograd.set_detect_anomaly(enable)


def check_finite(scalars, it):
    """Raise FloatingPointError naming iteration ``it`` when the step's
    ``loss`` scalar (a host float) is NaN or infinite."""
    loss = scalars.get("loss")
    if loss is not None and not math.isfinite(loss):
        raise FloatingPointError(f"training.debug_nans: loss is {loss} at "
                                 f"iteration {it}")


class StepTimer:
    """Rolling steps/sec + wall-clock accounting for the train loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self.t0 = time.time()
        self.stamps = []

    def tick(self):
        self.stamps.append(time.time())
        if len(self.stamps) > self.window:
            self.stamps.pop(0)

    @property
    def steps_per_sec(self):
        if len(self.stamps) < 2:
            return 0.0
        return (len(self.stamps) - 1) / max(self.stamps[-1] - self.stamps[0], 1e-9)

    @property
    def elapsed(self):
        return time.time() - self.t0


class ProfiledRegion:
    """Train-loop integration: starts a trace at ``start_step``, stops at
    ``stop_step`` and writes it under ``log_dir``
    (``trace_<start>_<stop>.json``), once; a no-op without ``log_dir``."""

    def __init__(self, log_dir, start_step=10, stop_step=20):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self._prof = None
        self._started = None
        self._done = False

    def maybe_start(self, step):
        # >= (not ==): a fused block advances several steps per call and
        # may never land exactly on start_step
        if (self.log_dir and self._prof is None and not self._done
                and step >= self.start_step):
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = _profile()
            self._prof.start()
            self._started = step

    def maybe_stop(self, step):
        if self._prof is not None and step >= self.stop_step:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            path = os.path.join(self.log_dir, f"trace_{self._started}_{step}.json")
            self._prof.export_chrome_trace(path)
            self._prof, self._done = None, True
            print(f"profiler trace written to {path}")
