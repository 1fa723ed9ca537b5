"""The port's tracer: spans at the layer boundaries of serving and
training, and counters where work is done or wasted.

Off by default. Off, ``span(name, **attrs)`` is one test of a module-level
bool that returns a shared no-op context, and ``count`` returns at once:
no span object, CUDA event or profiler range is made.

On (``enable()`` until ``disable()``), each span records its name, an id,
the id of the span open around it (its parent) and a job id: the id of the
outermost span open when it began (one ``BatchSynthesizer.synthesize_all``
call, or one training step), so every span of a job shares it. It records
its host start and end on ``time.perf_counter_ns()`` and its attributes.
With ``events`` it also records a ``torch.cuda.Event(enable_timing=True)``
on the current stream at each end; nothing here synchronises but
``collect()``, which resolves the events into the span's device time.
While ``torch.profiler`` records, each span also opens
``torch.profiler.record_function(name)``, so that the program's spans lie
in the profiler's timeline on the kernels' clock and an idle gap of the
device can be put down to the innermost span open over it.

Everything is held in memory until ``collect()``, which returns it and
clears it; ``export`` writes a collection as Chrome-trace JSON. Span names
start with ``dvt.``. The spans and counters of the serving and training
paths, and what each measures, are listed in PERF.md §3.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Union

import torch
from torch.autograd import profiler as _profiler

_on = False
_events = False
_spans: List["_Span"] = []
_counters: Dict[str, int] = collections.Counter()
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)


class _NoSpan:
    """The shared context ``span`` returns while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "job", "tid", "start_ns",
                 "end_ns", "marks", "_range", "_delta", "_before")

    def __init__(self, name: str, delta, attrs: Dict):
        self.name, self.attrs, self._delta = name, attrs, delta

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.job = stack[0].id if stack else self.id
        self.tid = threading.get_native_id()
        stack.append(self)
        self._before = self._delta() if self._delta is not None else None
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.marks = None
        if _events:
            self.marks = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            self.marks[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.marks is not None:
            self.marks[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._before is not None:
            after = self._delta()
            self.attrs["delta"] = {k: v - self._before.get(k, 0)
                                   for k, v in after.items()
                                   if v != self._before.get(k, 0)}
        _stack().pop()
        _spans.append(self)
        return False


def _stack() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def enable(events: Optional[bool] = None) -> None:
    """Turn the tracer on. ``events``: time each span on the device with
    CUDA events (default: when CUDA is available)."""
    global _on, _events
    _events = torch.cuda.is_available() if events is None else events
    _on = True


def disable() -> None:
    """Turn the tracer off; what it holds stays until ``collect()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, delta: Optional[Callable[[], Mapping[str, int]]] = None,
         **attrs):
    """A context that records one span while the tracer is on.
    ``delta``: a function of no arguments returning counts by name; the
    span records their change over it (the counts that moved) as
    ``attrs["delta"]``, calling it only while the tracer is on."""
    if not _on:
        return _NO_SPAN
    return _Span(name, delta, attrs)


def count(name: str, n: Union[int, torch.Tensor] = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on. ``n`` may
    be a one-element tensor (a count the device holds): it is added on its
    device and read as an int in ``collect()``, so that counting does not
    synchronise."""
    if _on:
        with _lock:
            _counters[name] += n


def collect() -> Dict[str, object]:
    """The spans finished and the counters since the last ``collect()``,
    cleared here: ``{"spans": [...], "counters": {...}}``. A span is a
    dict of ``name``, ``id``, ``parent``, ``job``, ``tid``, ``start_ns``,
    ``end_ns``, ``host_ms`` and ``device_ms`` (between its CUDA events, or
    None without them) and ``attrs``; the counters as ints. Synchronises
    the card first when a span holds events (and reading a count the card
    holds waits for it)."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, dict(_counters)
        _spans, _counters = [], collections.Counter()
    if any(s.marks is not None for s in spans):
        torch.cuda.synchronize()
    counters = {k: int(v) for k, v in counters.items()}
    out = []
    for s in spans:
        out.append(dict(
            name=s.name, id=s.id, parent=s.parent, job=s.job, tid=s.tid,
            start_ns=s.start_ns, end_ns=s.end_ns,
            host_ms=(s.end_ns - s.start_ns) / 1e6,
            device_ms=(s.marks[0].elapsed_time(s.marks[1])
                       if s.marks is not None else None),
            attrs=s.attrs))
    return {"spans": out, "counters": counters}


def export(path: str, collected: Mapping[str, object]) -> None:
    """Write ``collected`` (what ``collect()`` returned) to ``path`` as
    Chrome-trace JSON, which Perfetto and chrome://tracing open: one
    complete event a span, on the Unix clock in microseconds (the clock of
    a ``torch.profiler`` export), with its ids, device time and attributes
    as ``args``; the counters under ``otherData``."""
    offset_ns = time.time_ns() - time.perf_counter_ns()
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": "diff_vits_tpu_torch spans"}}]
    for s in collected["spans"]:
        events.append({
            "name": s["name"], "cat": "dvt", "ph": "X", "pid": pid,
            "tid": s["tid"], "ts": (s["start_ns"] + offset_ns) / 1e3,
            "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
            "args": dict(s["attrs"], id=s["id"], parent=s["parent"],
                         job=s["job"], device_ms=s["device_ms"])})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": collected["counters"]}},
                  f, default=str)
