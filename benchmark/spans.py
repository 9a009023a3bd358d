"""What the program's own tracing (``pcx_torch.tracing``) recorded over the
traced window, for the readers of span and counter metrics.  The totals
and counters are the program's since ``kernels.reset_launches()``, which
set-up calls just before the window, and the check after the window runs
nothing of the program.  A program without that module gives nothing.

A span's path is its name after those of the spans open around it, joined
by ``/``; the solve's loop is ``LOOP``.
"""

from __future__ import annotations

from typing import Optional

LOOP = "pcx.lobpcg"
SEP = "/"


def _tracing(run):
    if run.trace is None or not run.iterations:
        return None
    try:
        from pcx_torch import tracing
    except ImportError:
        return None
    return tracing


def totals(run) -> Optional[dict]:
    """{path: (count, host ms, device ms)} of the window, or None."""
    tracing = _tracing(run)
    return (tracing.totals() or None) if tracing else None


def counts(run) -> Optional[dict]:
    """The program's counters over the window, or None."""
    tracing = _tracing(run)
    return (tracing.counts() or None) if tracing else None


def loop_ms(tot: dict, names: tuple, field: int = 2) -> float:
    """Milliseconds (``field`` 1 host, 2 device) of the spans named in
    ``names`` inside the loop span, each counted once: a span inside
    another of ``names`` is part of it."""
    out = 0.0
    for path, rec in tot.items():
        parts = path.split(SEP)
        if LOOP not in parts[:-1]:
            continue
        inner = parts[parts.index(LOOP) + 1:]
        if inner[-1] in names and not set(inner[:-1]) & set(names):
            out += rec[field]
    return out
