"""The traced window: ``torch.profiler`` (CUPTI) over a lead-in and the
window, reduced in memory to what the per-layer metrics read.

The profile starts before an unmeasured lead-in, since a trace started
late in a process loses its first device events; only events inside the
``bench.window`` range count.  From them:

* ``busy_s``: the union of the device's kernel, copy and set intervals;
  ``window_s``: the range's length;
* ``kernel_s``: the summed device time of every kernel, whatever its
  name; ``kernels``: their number; ``launches``: the host's launch API
  calls (``cudaLaunch*`` / ``cuLaunch*``), which should equal it;
* ``device_ops``: the device operations that took the most time;
  ``idle_gaps``: the device's idle time by what the host was doing at
  the start of each gap (the innermost host event open then).

No chrome trace is written.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

WINDOW = "bench.window"
TOP = 10


class NoTrace:
    """The untraced run's stand-in: spans cost nothing."""

    def start(self):
        pass

    def open(self):
        pass

    def close(self):
        pass

    def stop(self):
        pass

    def span(self, name: str):
        return contextlib.nullcontext()

    def reduce(self):
        return None


class Trace(NoTrace):
    def __init__(self):
        self._prof = None
        self._range = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    def open(self):
        import torch
        torch.cuda.synchronize()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def close(self):
        import torch
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)

    def stop(self):
        self._prof.__exit__(None, None, None)

    def span(self, name: str):
        import torch
        return torch.profiler.record_function(name)

    def reduce(self) -> dict:
        from torch.autograd import DeviceType
        evs = []
        for e in self._prof.profiler.kineto_results.events():
            kind = "cpu"
            if e.device_type() == DeviceType.CUDA:
                kind = _device_kind(e)
            evs.append((e.name(), kind, e.start_ns(), e.end_ns()))
        self._prof = None
        return reduce_events(evs)


def _device_kind(e) -> str:
    """``kernel``, ``copy`` (memcpy / memset) or ``annotation``."""
    act = str(getattr(e, "activity_type", lambda: "")()).lower()
    name = e.name()
    if "annotation" in act or name.startswith("bench."):
        return "annotation"
    if "memcpy" in act or "memset" in act or name.startswith(("Memcpy",
                                                              "Memset")):
        return "copy"
    return "kernel"


def _is_launch(name: str) -> bool:
    return name.startswith(("cudaLaunch", "cuLaunch"))


def reduce_events(evs: list) -> dict:
    """``evs``: ``(name, kind, start_ns, end_ns)`` with kind ``cpu``,
    ``kernel``, ``copy`` or ``annotation``; the window is the CPU event
    named :data:`WINDOW`."""
    wins = [(s, e) for n, k, s, e in evs if n == WINDOW and k == "cpu"]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} window ranges")
    w0, w1 = wins[0]
    dev = sorted((s, e, n, k) for n, k, s, e in evs
                 if k in ("kernel", "copy") and s >= w0 and e <= w1)
    kernels = [x for x in dev if x[3] == "kernel"]
    launches = sum(1 for n, k, s, e in evs
                   if k == "cpu" and _is_launch(n) and w0 <= s <= w1)
    busy, gaps, cur_s, cur_e = 0, [], w0, w0
    for s, e, _, _ in dev:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    by_op = defaultdict(int)
    for s, e, n, _ in dev:
        by_op[n[:80]] += e - s
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        kernel_s=sum(e - s for s, e, _, _ in kernels) / 1e9,
        kernels=len(kernels), launches=launches,
        device_ops=_top(by_op), idle_gaps=_top(_gaps_by_host(evs, gaps)))


def _gaps_by_host(evs: list, gaps: list) -> dict:
    """Idle seconds by the innermost host event open at each gap's start
    (``host idle`` where none is)."""
    host = sorted((s, e, n) for n, k, s, e in evs
                  if k == "cpu" and n != WINDOW)
    starts = [h[0] for h in host]
    out = defaultdict(int)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = "host idle"
        for j in range(i, max(-1, i - 256), -1):
            if host[j][1] > g0:
                name = host[j][2]
                break
        out[name[:80]] += g1 - g0
    return out


def _top(d: dict) -> list:
    return [[n, ns / 1e9] for n, ns in sorted(d.items(), key=lambda x: -x[1])
            [:TOP]]
