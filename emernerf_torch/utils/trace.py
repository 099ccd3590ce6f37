"""Spans at the port's layer boundaries, on the host's clock.

``with span(name):`` marks one piece of the launching thread's
work: an iteration (``trainer.iteration``), a branch of the step, a render,
an eval chunk.  Tracing is off unless ``enable()`` turned it on; off,
``span`` returns one shared object whose ``with`` does nothing (no record,
no clock read, no torch call), so the spans stay in the main path.

On, every span appends one :class:`Record` when it closes, kept in memory
until ``disable()`` returns them.  A span opened with no span around it is
a unit (an iteration, a frame): every span inside it carries its id.  The
stamps are ``time.perf_counter_ns()`` moved onto ``time.time_ns()``'s clock
by the offset taken at ``enable``: the clock that ``torch.profiler``'s
events are on (Kineto's ``trace_start_ns`` plus an event's relative
start), so a device idle gap can be put down to the span the host was in.
With ``annotate=True`` each span also enters
``torch.profiler.record_function(name)``, which puts it in a profiler's
chrome trace over the kernels it launched; it also adds profiler events,
so a reader that counts the profiler's events leaves it off.

A record holds a name and two stamps, nothing more: how much work a span
did (rays, samples) is the caller's to know.  Spans are opened and closed
by one thread (the one that launches the work), properly nested.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import torch


class Record(NamedTuple):
    """One closed span.  ``parent`` is 0 for a unit, whose ``unit`` is its
    own ``id``; the stamps are ns on ``time.time_ns()``'s clock."""

    id: int
    parent: int
    unit: int
    name: str
    start_ns: int
    end_ns: int


class _Off:
    """The span tracing hands out while off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Tracer:
    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.records: List[Record] = []
        self.stack: List["_Span"] = []
        self.next_id = 1


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "unit", "start", "fn")

    def __init__(self, tracer: _Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        self.id = tr.next_id
        tr.next_id += 1
        outer = tr.stack[-1] if tr.stack else None
        self.parent = outer.id if outer else 0
        self.unit = outer.unit if outer else self.id
        tr.stack.append(self)
        self.fn = None
        if tr.annotate:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self.tracer
        if self.fn is not None:
            self.fn.__exit__(*exc)
        tr.stack.pop()
        tr.records.append(Record(self.id, self.parent, self.unit, self.name,
                                 self.start + tr.offset_ns, end + tr.offset_ns))
        return False


_tracer: Optional[_Tracer] = None


def span(name: str):
    """A context manager over one piece of work named ``name``."""
    if _tracer is None:
        return _OFF
    return _Span(_tracer, name)


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _tracer is not None


def enable(annotate: bool = False) -> None:
    """Start recording spans (``annotate``: each also a
    ``torch.profiler.record_function``).  Raises if already on."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("span tracing is on already")
    _tracer = _Tracer(annotate)


def disable() -> List[Record]:
    """Stop recording; the spans closed since ``enable``, in the order they
    closed (an empty list where tracing was off)."""
    global _tracer
    tr, _tracer = _tracer, None
    if tr is None:
        return []
    # a span still open appends to a list no one reads
    records, tr.records = tr.records, []
    return records
