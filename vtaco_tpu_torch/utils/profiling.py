"""Tracing, the port's spans and counters, step timing and NaN checks
(port of vtaco_tpu/utils/profiling.py:29-95 on torch.profiler).

  * ``trace(log_dir)``: a torch.profiler trace of the block (the host's
    operations, and the card's kernels where there is one), written to
    ``log_dir`` as a Chrome trace (chrome://tracing, Perfetto).
  * ``span(name)``, ``count(name, n)``: the port's one span and counter
    store, in memory, read through ``records()`` and ``counters()`` and
    emptied by ``reset()``. It is on exactly while torch's profiler records
    on the calling thread (``trace``, ``ProfiledRegion``, any
    ``torch.profiler.profile``); otherwise a span or a count costs one
    check of that flag and nothing more. A span then records its name, its
    start and end on the profiler's own clock (``time.time_ns``), its id,
    its parent's and its root's, and opens a profiler range of its name,
    so that the trace shows the program's stages. While a root span is
    open, each synchronizing call that torch reports on the card counts
    under ``sync`` and ``sync.<innermost open span>``.
  * ``host_syncs(fn, ...)``: the synchronizing calls of one call, by site.
  * ``debug_nans(enable)``: autograd's anomaly mode for the block
    (torch.autograd.set_detect_anomaly), the counterpart of JAX's
    ``jax_debug_nans``; ``check_finite`` stops a run at the first step
    whose loss is not finite.
  * ``StepTimer``: rolling steps per second for the train loop's prints.
  * ``ProfiledRegion``: the loop's ``training.profile_dir`` trace of steps
    ``start_step`` to ``stop_step``.

Only the thread that launches work opens spans: the profiler's flag is
the calling thread's, so a span or a count on another thread (a loader's
workers) is off even while the profiler records.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
import time
import warnings

import torch

_on = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_SYNC = "called a synchronizing CUDA operation"

Record = collections.namedtuple("Record", "name start end id parent root")
Record.__doc__ = """A closed span: start and end in ns on ``time.time_ns``'s clock,
which the profiler's events share; ``parent`` is None for a root."""


class _Tracer:
    """The store behind ``span`` and ``count``: closed spans, counters, the
    stack of open spans."""

    def __init__(self):
        self.records = []
        self.counters = {}
        self.stack = []
        self.ids = itertools.count()


_TRACER = _Tracer()


class _SyncWatch:
    """torch's synchronization debugging ('warn') over a block, its
    warnings caught: each synchronizing call that torch reports on the card
    is handed to ``on_sync(filename, lineno)``; other warnings pass on. The
    previous mode is restored after. Without a card, a no-op."""

    def __init__(self, on_sync):
        self.on_sync = on_sync
        self._caught = None

    def __enter__(self):
        if not torch.cuda.is_available():
            return self
        self._caught = warnings.catch_warnings()
        self._caught.__enter__()
        warnings.filterwarnings("always", message=".*" + _SYNC)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC in str(message):
                self.on_sync(filename, lineno)
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self._caught is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._caught.__exit__(*exc)
            self._caught = None
        return False


class _Span:
    """An open span (``span`` returns one while the profiler records)."""

    __slots__ = ("name", "id", "parent", "root", "start", "_range", "_watch")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _TRACER.stack
        self.id = next(_TRACER.ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self._watch = None if stack else _SyncWatch(_count_sync).__enter__()
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        end = time.time_ns()       # the range takes its end late in its exit
        _TRACER.stack.remove(self)
        _TRACER.records.append(Record(self.name, self.start, end, self.id, self.parent,
                                      self.root))
        if self._watch is not None:
            self._watch.__exit__(*exc)
        return False


def _count_sync(filename, lineno):
    count("sync")
    if _TRACER.stack:
        count("sync." + _TRACER.stack[-1].name)


def span(name: str):
    """A context: the span ``name`` while the profiler records on this
    thread, else nothing."""
    if not _on():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while the profiler records on this
    thread."""
    if _on():
        _TRACER.counters[name] = _TRACER.counters.get(name, 0) + n


def records():
    """The closed spans (``Record``s) in the order they closed."""
    return _TRACER.records


def counters():
    """{name: count}."""
    return _TRACER.counters


def reset():
    """Forget every closed span and counter."""
    _TRACER.records = []
    _TRACER.counters = {}


def host_syncs(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` with torch's synchronization debugging on:
    (its result, [(file, line) of each synchronizing call]). The mode sees
    the waits that torch's own CUDA operations report, such as ``.item()``,
    ``.cpu()`` and data-dependent shapes."""
    sites = []
    with _SyncWatch(lambda filename, lineno: sites.append((filename, lineno))):
        out = fn(*args, **kw)
    return out, sites


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
    """Rolling steps/sec + wall-clock accounting for the train loop (its
    ticks follow each step's host read of its scalars, which waits for the
    card)."""

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
