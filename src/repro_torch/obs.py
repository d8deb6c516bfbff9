"""Spans and counters of the scenario path, on the profiler's clock.

``kvsim.run_scenario`` records while a ``torch.profiler`` session is
collecting (``torch._C._autograd._profiler_enabled()``, read once on
entry): the active steps of a schedule, not its wait and warm-up steps.
Everything else, ``run_scenario_reference`` included, records nothing. A
span is a stage of one scenario (its name, the scenario's id, the index of
its parent span, and its start and end in ``time.time_ns()``, the clock
the profiler stamps its host records with), so a trace's device records
can be attributed to the stage that launched them. A scenario also counts
``chunks`` (ticks replayed) and ``sweeps`` (due policy steps), the
divisors of a per-tick reading.

The stages, from the root down::

    scenario                      all of run_scenario: set-up, loop, epilogue
      chunk                       one tick of the chunk loop
        fault_prepass  routing_prepass  contention_prepass
        attribution_components
          attribution_fold  flight_recorder
        chunk_replay  fault_counters  occupancy  record_accesses
        policy_step               a due tick's daemon step
          decide  capacity_projection  count_decay  sweep_stats
        repair_accounting  publish
      static_replay               the frozen-map path

Spans stay in memory until :func:`reset`; :func:`recorded` returns them.
With no scenario being recorded a site costs one global read: ``span``
returns one shared no-op context and ``count`` returns at once.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

__all__ = ["COUNTERS", "ScenarioRecord", "Span", "count", "each", "recorded", "reset",
           "scenario", "span"]

COUNTERS = ("chunks", "sweeps")


class Span(NamedTuple):
    """One stage of one scenario, on ``time.time_ns()``'s clock."""

    name: str
    scenario: int  # the id every span of one scenario shares
    parent: int  # index of the enclosing span in the scenario's spans; -1 at the root
    start_ns: int
    end_ns: int


class ScenarioRecord(NamedTuple):
    """What one recorded scenario left: its spans in start order (a parent
    before its children) and its counters."""

    id: int
    spans: list
    counters: dict


class _Record:
    """The scenario being recorded: open rows ``[name, parent, start,
    end]`` and the stack of the open spans' indices."""

    __slots__ = ("id", "rows", "stack", "counters")

    def __init__(self, rid: int):
        self.id, self.rows, self.stack = rid, [], []
        self.counters = dict.fromkeys(COUNTERS, 0)


class _Site:
    """The context of one span of the scenario being recorded."""

    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: _Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.index = len(rec.rows)
        rec.rows.append([self.name, rec.stack[-1] if rec.stack else -1, time.time_ns(), 0])
        rec.stack.append(self.index)

    def __exit__(self, *exc) -> bool:
        self.rec.rows[self.index][3] = time.time_ns()
        self.rec.stack.pop()
        return False


_NOOP = contextlib.nullcontext()
_current: _Record | None = None  # the scenario being recorded
_done: list = []  # finished _Records, oldest first
_next_id = 0


def span(name: str):
    """The context that marks stage ``name`` of the scenario being
    recorded; a shared no-op context when there is none."""
    rec = _current
    return _NOOP if rec is None else _Site(rec, name)


def each(name: str, items):
    """``items``, each inside a span ``name`` (closed when the next item is
    asked for, or the loop ends); ``items`` itself when nothing records."""
    rec = _current
    return items if rec is None else _each(rec, name, items)


def _each(rec: _Record, name: str, items):
    for item in items:
        with _Site(rec, name):
            yield item


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to the counter ``name`` of the scenario
    being recorded."""
    rec = _current
    if rec is not None:
        rec.counters[name] += n


@contextlib.contextmanager
def scenario():
    """Record one scenario under the root span ``scenario`` while a
    profiler session collects; otherwise record nothing. Also a decorator
    (``@obs.scenario()``), which checks the session at each call."""
    global _current, _next_id
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    prev, rec = _current, _Record(_next_id)
    _next_id += 1
    _current = rec
    try:
        with _Site(rec, "scenario"):
            yield
    finally:
        _current = prev
        _done.append(rec)


def recorded() -> list:
    """Every scenario recorded since :func:`reset`, oldest first, as
    :class:`ScenarioRecord`\\ s."""
    return [ScenarioRecord(rec.id, [Span(name, rec.id, parent, s, e)
                                    for name, parent, s, e in rec.rows], dict(rec.counters))
            for rec in _done]


def reset() -> None:
    """Forget every recorded scenario."""
    _done.clear()
