"""Spans and counters of the port's host work, kept in memory on the
device trace's clock.

A span is a :class:`Span` ``(name, id, parent, start_ns, end_ns,
attrs)``; a counter is a named integer.  Spans go into one bounded ring
(:data:`CAPACITY` records, the oldest dropped first and counted);
:func:`snapshot` reads the ring and the counters, :func:`clear` empties
both.  Nothing is written to disk.

**When it records.**  While :func:`enable` is in force, or while any
``torch.profiler`` session is active: a profiled run records its spans
with no other switch.  Off, :func:`span` returns one shared no-op
context after a single check, and :func:`record` and :func:`count`
return after the same check: nothing is allocated, no clock is read and
no device work is added.

**The clock.**  Callers hand :func:`record` the readings they already
take, as ``time.perf_counter_ns`` values; a record holds them on the
wall clock (``time.time_ns``) that the profiler's host events carry,
through one ``(perf_counter_ns, time_ns)`` pair read together when
recording starts.  A caller on a clock of its own (a service's virtual
clock) passes ``own_clock=True``, and its readings are kept as they are.
While a profiler is active, :func:`span` is also a profiler range of its
name, so the device trace places the same host work on its own clock.
The range is a record function of the operators' scope
(``torch._C._profiler._RecordFunctionFast``), not the user scope of
``torch.profiler.record_function``: the profiler copies a user range
that launches device work onto the device's timeline as an annotation,
which a trace's count of kernels would take for a kernel.  A span that
crosses calls (a request's queue or in-flight time) is a :func:`record`
alone, never a range: ranges that do not nest would corrupt the trace's
innermost-host-event attribution.

**Ids.**  A :func:`span` opened with an ``id`` is the :func:`current`
parent for the records made inside it, so a fleet launched by a service
dispatch carries the dispatch's id.  :func:`next_id` hands out ids that
no other caller in the process gets.

Program spans never start with ``bench.``, which the benchmark keeps
for its own ranges.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from types import MappingProxyType
from typing import NamedTuple, Optional

import torch

#: spans the ring holds; older ones are dropped (and counted)
CAPACITY = 1 << 16

#: the profiler's switch (true while any torch.profiler session records)
_profiling = torch.autograd._profiler_enabled
#: a host range of the operators' scope
_Range = torch._C._profiler._RecordFunctionFast

_NO_ATTRS = MappingProxyType({})


class Span(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]
    start_ns: int
    end_ns: int
    attrs: MappingProxyType

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _State:
    """The process's recorder (one, since the profiler it follows is one
    per process)."""

    def __init__(self):
        self.enabled = 0            # depth of enable()
        self.ring: deque = deque(maxlen=CAPACITY)
        self.dropped = 0
        self.counters: dict = {}
        self.offset_ns: Optional[int] = None   # time_ns - perf_counter_ns
        self.parents: list = []     # ids of the open spans given one
        self.ids = itertools.count(1)


_S = _State()


def recording() -> bool:
    return bool(_S.enabled) or _profiling()


def _offset_ns() -> int:
    """time_ns less perf_counter_ns, from one pair read together (the
    perf_counter reading taken as the middle of two around time_ns)."""
    if _S.offset_ns is None:
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        _S.offset_ns = wall - (p0 + p1) // 2
    return _S.offset_ns


class _Enabled:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        disable()


def enable() -> _Enabled:
    """Record until :func:`disable` (or for a ``with`` block); calls
    nest.  The clock pair is read anew when recording starts here."""
    if not _S.enabled:
        _S.offset_ns = None
        _offset_ns()
    _S.enabled += 1
    return _Enabled()


def disable() -> None:
    _S.enabled = max(0, _S.enabled - 1)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "_rf", "_pushed")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id
        self._rf = None
        self._pushed = False

    def __enter__(self):
        if _profiling():
            self._rf = _Range(self.name)
            self._rf.__enter__()
        if self.id is not None:
            _S.parents.append(self.id)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            _S.parents.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return None


def span(name: str, id: Optional[int] = None):
    """A context around synchronous host work: a profiler range of
    ``name`` while a profiler is active; with ``id``, the
    :func:`current` parent inside it.  It records nothing itself: the
    caller :func:`record`\\ s its own readings."""
    if not (_S.enabled or _profiling()):
        return _NOOP
    return _Span(name, id)


def current() -> Optional[int]:
    """The id of the innermost open :func:`span` given one (None)."""
    return _S.parents[-1] if _S.parents else None


def next_id() -> int:
    return next(_S.ids)


def record(name: str, start_ns: int, end_ns: int, id: Optional[int] = None,
           parent: Optional[int] = None, attrs: Optional[dict] = None,
           own_clock: bool = False) -> None:
    """Keep one span: ``start_ns`` / ``end_ns`` are ``perf_counter_ns``
    readings (moved to the wall clock here) or, with ``own_clock``, the
    caller's clock in nanoseconds, kept as they are."""
    if not (_S.enabled or _profiling()):
        return
    if not own_clock:
        off = _offset_ns()
        start_ns, end_ns = start_ns + off, end_ns + off
    if len(_S.ring) == CAPACITY:
        _S.dropped += 1
    _S.ring.append(Span(name, id, parent, int(start_ns), int(end_ns),
                        MappingProxyType(attrs) if attrs else _NO_ATTRS))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (while recording)."""
    if not (_S.enabled or _profiling()):
        return
    _S.counters[name] = _S.counters.get(name, 0) + n


def snapshot() -> dict:
    """``spans`` (the ring, oldest first), ``counters`` and ``dropped``
    (spans the ring let go)."""
    return dict(spans=list(_S.ring), counters=dict(_S.counters),
                dropped=_S.dropped)


def clear() -> None:
    """Empty the ring and the counters; the next record reads the clock
    pair anew."""
    _S.ring.clear()
    _S.counters.clear()
    _S.dropped = 0
    _S.offset_ns = None
