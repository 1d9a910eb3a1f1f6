"""The traced run's instruments: spans recorded from the benchmark's own
files around the calls into each layer, and torch.profiler over a steady
part of the window.

``Spans`` times a named stage of each request by CUDA events (the
device's timeline between two points of the stream) or by the host's
clock. ``Profiled`` reads the profiler's device activity: the seconds in
which a kernel, copy or fill ran (the union of their intervals), kernel
time by name, the longest idle gaps labelled by the host range that was
open, and the device operations that took the most time.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    """Per-request stage times in ms. Disabled, every context is free."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._events = []          # (name, start event, end event)
        self.host = {}             # name -> [ms]

    def reset(self):
        """Forget what was recorded so far (the warm-up's spans)."""
        self._events = []
        self.host = {}

    @contextlib.contextmanager
    def device(self, name):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.profiler.record_function(name):
            yield
        end.record()
        self._events.append((name, start, end))

    @contextlib.contextmanager
    def host_clock(self, name):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.host.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def wrap(self, obj, attr, name):
        """Put a device span around every call of ``obj.attr`` (an
        instance attribute shadowing the method; the object is the
        program's, the span the benchmark's)."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.device(name):
                return fn(*a, **kw)
        setattr(obj, attr, spanned)

    def device_ms(self) -> dict:
        """{name: [ms per span]} once the stream has passed every end."""
        torch.cuda.synchronize()
        out = {}
        for name, s, e in self._events:
            out.setdefault(name, []).append(s.elapsed_time(e))
        return out


def _ns(ev, what):
    """A KinetoEvent's start or duration in ns, across torch versions."""
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(ev, what + "_us")() * 1000


def _is_device(ev):
    """A kernel, copy or fill on the card (not a user annotation, which
    the profiler mirrors onto the device's timeline)."""
    return ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation()


def warm_profiler(dev):
    """Start and stop the profiler once, so that its first start (CUPTI's
    initialization, seconds) falls into set-up and not into the window."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)


class Profiled:
    """torch.profiler over a block of requests or steps. After the block
    and ``read()``: ``busy_s``, ``window_s``, ``kernels`` ({name: [seconds,
    count]}), ``top_ops`` and ``idle_gaps``."""

    WINDOW = "port_bench.window"

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = torch.profiler.record_function(self.WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def read(self):
        """Reduce the recorded events (once the window has closed)."""
        self._read(self._prof.profiler.kineto_results.events())
        del self._prof
        return self

    def _read(self, events):
        host = []
        dev = []
        for ev in events:
            start, dur = _ns(ev, "start"), _ns(ev, "duration")
            if _is_device(ev):
                dev.append((start, start + dur, ev.name()))
            else:
                host.append((start, start + dur, ev.name()))
        win = [h for h in host if h[2] == self.WINDOW]
        if not win:
            raise RuntimeError("the profiler recorded no window range")
        w0, w1 = win[0][0], win[0][1]
        dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1)
        self.window_s = (w1 - w0) / 1e9
        self.n_kernels = sum(not n.startswith(("Memcpy", "Memset")) for _, _, n in dev)
        kernels = {}
        for s, e, n in dev:
            k = kernels.setdefault(n, [0.0, 0])
            k[0] += (e - s) / 1e9
            k[1] += 1
        self.kernels = kernels
        self.top_ops = sorted(([n, v[0]] for n, v in kernels.items()),
                              key=lambda x: -x[1])[:10]
        # the union of device intervals, and the gaps between them
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                elif s > w0:
                    gaps.append((w0, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if w1 > cur_e:
                gaps.append((cur_e, w1))
        self.busy_s = busy / 1e9
        self.idle_gaps = self._label(gaps, [h for h in host if h[2] != self.WINDOW])

    @staticmethod
    def _label(gaps, host):
        """The 10 longest gaps, each named by the innermost benchmark span
        (a name with a dot) open at its middle, else the innermost host
        range; equal names summed."""
        spans = [h for h in host if "." in h[2] and not h[2].startswith("aten")]
        named = {}
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
            mid = (s + e) / 2
            open_ = [h for h in spans if h[0] <= mid <= h[1]] or \
                [h for h in host if h[0] <= mid <= h[1]]
            name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "no host range"
            named[name] = named.get(name, 0.0) + (e - s) / 1e9
        return sorted(([n, v] for n, v in named.items()), key=lambda x: -x[1])[:10]

    def kernel_s(self, *parts) -> tuple:
        """(seconds, launches) of the kernels whose name holds every one of
        ``parts``."""
        s, n = 0.0, 0
        for name, (t, c) in self.kernels.items():
            if all(p in name for p in parts):
                s += t
                n += c
        return s, n
