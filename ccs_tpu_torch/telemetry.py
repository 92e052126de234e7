"""Spans and counters of one ccs_tpu_torch run.

A ``Recorder`` times the stages of the host pipeline and of the device
step where the work happens. A span (``Recorder.span``, a context manager)
has a name, the thread it ran on, a start and an end on
``time.perf_counter_ns`` (CLOCK_MONOTONIC on Linux) and a parent, the
enclosing span of the same thread. The recorder always keeps, per span
name, the seconds and the number of spans, summed over threads (spans of
the shard and prepare threads add up to thread-seconds), and plain
counters. That costs two clock reads and one locked add per span; spans sit
at chunk, batch and loop-iteration granularity, never per base or per op.
A span must not nest inside one of its own name, which would count its
time twice.

With ``timeline`` the recorder also keeps every span in a ring of
``RING_SPANS`` (the oldest are dropped, and ``dropped`` counts them); the
CLI asks for it only under ``--tpu-profile-dir`` and writes it out when the
run ends, in one Chrome trace with the device's events (``chrome_trace``).
The recorder's ``anchor`` pairs ``perf_counter_ns`` with ``time_ns``, the
clock of ``torch.profiler``'s events, so ``to_wall_ns`` puts a span on the
device trace's clock.

This module imports neither torch nor numpy: the prepare workers load the
package without them.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import threading
import time
from typing import Iterable, Mapping, NamedTuple, Optional, Sequence

RING_SPANS = 1 << 19   # spans a timeline keeps (~100 MB at most)

# the fields of the CLI's "wall split" line, in order: (name, unit). A
# field in seconds is the total of the span of that name, except
# ``device_wait``, the host blocked on the card inside the device step
# (``sync`` + ``pull``); any other is the counter of that name (a span's
# count where a span has the name). The first four stand where the line
# has always had them.
WALL_SPLIT_FIELDS = (
    ("prepare", "thread-s"), ("device_step", "s"), ("device_wait", "s"),
    ("finalize", "s"),
    ("prepare_wait", "s"), ("pack", "s"), ("h2d", "s"), ("sync", "s"),
    ("pull", "s"), ("handoff_wait", "s"), ("write", "s"), ("read", "s"),
    ("pipeline", "s"),
    ("sync", "calls"), ("windows_polished", "windows"),
    ("polish_iterations", "iterations"), ("windows_converged", "windows"),
)
_SECONDS = ("s", "thread-s")

NO_SPAN = "(no span)"   # idle_by_span's key for time under no span


class Span(NamedTuple):
    id: int
    parent: int      # the enclosing span's id on the same thread, 0: none
    name: str
    thread: str
    start_ns: int    # perf_counter_ns
    end_ns: int


class _Open:
    """One span while it runs."""

    __slots__ = ("rec", "name", "id", "parent", "t0")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._stack().pop()
        with rec._lock:
            rec._ns[self.name] = rec._ns.get(self.name, 0) + t1 - self.t0
            rec._counts[self.name] = rec._counts.get(self.name, 0) + 1
            if rec._ring is not None:
                if len(rec._ring) == rec._ring_size:
                    rec.dropped += 1
                rec._ring.append(Span(self.id, self.parent, self.name,
                                      threading.current_thread().name,
                                      self.t0, t1))


class Recorder:
    """Span totals and counters of one run; with ``timeline``, every span
    as well (see the module docstring)."""

    def __init__(self, timeline: bool = False, ring: int = RING_SPANS):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._ns: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        self._ring_size = ring
        self._ring = collections.deque(maxlen=ring) if timeline else None
        self.dropped = 0
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str) -> _Open:
        return _Open(self, name)

    def add_time(self, name: str, seconds: float) -> None:
        """One span's worth of total without a span (work timed where no
        recorder is, as in a prepare worker process)."""
        with self._lock:
            self._ns[name] = self._ns.get(name, 0) + int(seconds * 1e9)
            self._counts[name] = self._counts.get(name, 0) + 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def seconds(self, name: str) -> float:
        return self._ns.get(name, 0) * 1e-9

    def counter(self, name: str) -> int:
        """A plain counter, or the number of spans of that name."""
        return self._counts.get(name, 0)

    def wall_split(self) -> tuple:
        """The values of ``WALL_SPLIT_FIELDS``, in order."""
        with self._lock:
            out = []
            for name, unit in WALL_SPLIT_FIELDS:
                if name == "device_wait":
                    out.append(self.seconds("sync") + self.seconds("pull"))
                elif unit in _SECONDS:
                    out.append(self.seconds(name))
                else:
                    out.append(self.counter(name))
            return tuple(out)

    def timeline(self) -> list[Span]:
        """The spans kept (oldest first); empty without a timeline."""
        with self._lock:
            return list(self._ring or ())

    def to_wall_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` reading on ``time_ns``'s clock."""
        return t_ns - self.anchor[0] + self.anchor[1]


_NO_SPAN = contextlib.nullcontext()


def span(rec: Optional[Recorder], name: str):
    """``rec.span(name)``, or nothing where the caller was given no
    recorder."""
    return _NO_SPAN if rec is None else rec.span(name)


def wall_split_format() -> str:
    """The CLI's "wall split" log format: each field as name value unit."""
    return "wall split: " + ", ".join(
        f"{name} {'%.3f' if unit in _SECONDS else '%d'} {unit}"
        for name, unit in WALL_SPLIT_FIELDS)


# ---- the device trace's clock ----

def _union(intervals: Iterable[tuple[int, int]]) -> list[list[int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans: Iterable[Span]) -> list[tuple[int, int, str]]:
    """The nested spans of one thread as disjoint (start, end, name)
    pieces, each named by the innermost span over it."""
    pieces: list[tuple[int, int, str]] = []
    open_: list[tuple[int, str]] = []      # (end, name), innermost last
    cur = 0
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while open_ and open_[-1][0] <= s.start_ns:
            end, name = open_.pop()
            pieces.append((cur, end, name))
            cur = end
        if open_:
            pieces.append((cur, s.start_ns, open_[-1][1]))
        open_.append((s.end_ns, s.name))
        cur = s.start_ns
    while open_:
        end, name = open_.pop()
        pieces.append((cur, end, name))
        cur = end
    return [p for p in pieces if p[1] > p[0]]


def idle_by_span(device_intervals: Mapping[object, Sequence[tuple[int, int]]],
                 spans: Iterable[Span]) -> dict:
    """Where the host was while each device sat idle.

    ``device_intervals``: per device, its activity as (start, end) in ns;
    ``spans``: the spans of the thread that issues the device work, on the
    same clock. The idle gaps are those between the union of a device's
    intervals. Returns, per device, the seconds of its gaps spent under
    each span name (the innermost span at each instant) and under
    ``NO_SPAN``."""
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    out = {}
    for dev, ivs in device_intervals.items():
        busy = _union(ivs)
        by_name: dict[str, float] = {}
        for (_a, g0), (g1, _b) in zip(busy, busy[1:]):
            covered = 0
            k = max(0, bisect.bisect_right(starts, g0) - 1)
            while k < len(pieces) and pieces[k][0] < g1:
                a, b, name = pieces[k]
                lap = min(b, g1) - max(a, g0)
                if lap > 0:
                    by_name[name] = by_name.get(name, 0.0) + lap * 1e-9
                    covered += lap
                k += 1
            if g1 - g0 > covered:
                by_name[NO_SPAN] = by_name.get(NO_SPAN, 0.0) + \
                    (g1 - g0 - covered) * 1e-9
        out[dev] = by_name
    return out


def chrome_trace(rec: Recorder, device_events: Iterable[tuple]) -> dict:
    """One Chrome trace of the run: the device's events ((device, stream,
    category, name, start ns, end ns) on ``time_ns``'s clock, as
    ``torch.profiler`` gives them) on a track per device and stream, and
    the recorder's timeline on a track per host thread, on the same clock.
    Times are in microseconds from the recorder's anchor."""
    base = rec.anchor[1]
    events = [{"ph": "M", "name": "process_name", "pid": "host",
               "args": {"name": "host threads (program spans)"}}]
    for dev, stream, cat, name, a, b in device_events:
        events.append({"ph": "X", "cat": cat, "name": name,
                       "pid": f"device {dev}", "tid": f"stream {stream}",
                       "ts": (a - base) / 1e3, "dur": (b - a) / 1e3})
    for s in rec.timeline():
        a = rec.to_wall_ns(s.start_ns)
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": "host", "tid": s.thread,
                       "ts": (a - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"base_time_ns": base,
                          "spans_dropped": rec.dropped}}
