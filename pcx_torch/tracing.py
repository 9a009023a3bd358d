"""The program's spans and counters: where a solve spends its time, by
layer, and how often it does what costs (operator applies, host syncs).

``span(name)`` marks a stretch of the program as one step of a layer.  It
records only while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``); otherwise it returns one shared
no-op context, and that check is all it costs.  While it records, a span

* enters ``torch.profiler.record_function(name)``, so that it sits in the
  profiler's timeline beside the device kernels, on the profiler's clock;
* times itself on the host clock, and on the device by two CUDA events on
  the current stream (the host clock again where CUDA is not in use);
* adds its count and times to a total kept by its path: its name and the
  names of the spans open around it, joined by ``/``
  (``pcx.solve/pcx.lobpcg/pcx.op/pcx.diel``).  A layer's self time is its
  path's time less that of the paths one name longer.

Device times are read from their events once these have completed, so
that a long sweep keeps only a bounded number of events in flight.

``count(name, n)`` adds to a plain counter, with or without a profiler.

``totals()`` and ``counts()`` read what was recorded since the last
``reset()`` (``pcx_torch.kernels.reset_launches`` resets it too).
"""

from __future__ import annotations

import collections
import functools
import time

import torch

SEP = "/"
FOLD_AT = 256      # spans in flight on the device before completed ones fold


class _Noop:
    """The span while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_open: list = []              # names of the open spans, outermost first
_totals: dict = {}            # path -> [count, host ns, device ms]
_pending = collections.deque()  # (total, start event, end event)
_free: list = []              # CUDA events to record again
_counts: dict = {}


def span(name: str):
    """A context that records ``name`` while a profiler records, else a
    shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    return dict(_counts)


def totals() -> dict:
    """{path: (count, host ms, device ms)} of the spans since the last
    reset; waits for the device once if any span's events are in flight."""
    if _pending:
        torch.cuda.synchronize()
        _fold(True)
    return {p: (c, h / 1e6, d) for p, (c, h, d) in _totals.items()}


def reset() -> None:
    _totals.clear()
    _pending.clear()
    _counts.clear()


def _event() -> torch.cuda.Event:
    ev = _free.pop() if _free else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _fold(done: bool) -> None:
    """Add the device time of the spans whose events have completed (all
    of them when ``done``: the device was synchronised), oldest first."""
    while _pending:
        tot, start, end = _pending[0]
        if not (done or end.query()):
            return
        _pending.popleft()
        tot[2] += start.elapsed_time(end)
        _free.extend((start, end))


class _Span:
    __slots__ = ("name", "rf", "tot", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _open.append(self.name)
        self.tot = _totals.setdefault(SEP.join(_open), [0, 0, 0.0])
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = _event() if torch.cuda.is_initialized() else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        try:
            self.tot[0] += 1
            self.tot[1] += host_ns
            if self.start is None:
                self.tot[2] += host_ns / 1e6
            else:
                _pending.append((self.tot, self.start, _event()))
                if len(_pending) >= FOLD_AT:
                    _fold(False)
        finally:
            self.rf.__exit__(*exc)
            _open.pop()
        return False
