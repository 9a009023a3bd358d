"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: device intervals by kernel name, their union (an
interval in which any operation ran on the device counts once, however
many overlap), the idle gaps between them named by the host operation that
spans each, and device time by kernel family.

The families are a copy of ``pcx_torch/profile_solve.py``'s ``FAMILIES``:
substrings of the device event's name, first match wins.
"""

from __future__ import annotations

import bisect
import collections
from typing import NamedTuple

WINDOW = "benchmark_window"   # the record_function around the window
NAME_CHARS = 120              # of a name in the breakdown
MIN_GAP_NS = 10_000           # idle gaps shorter than this are not named
MAX_SCAN = 20_000             # host events looked at to name one gap

FAMILIES = (
    ("K2 axis_dft", ("axis_dft_kernel",)),
    ("K3 gram9", ("gram9_partial_kernel", "gram9_reduce_kernel")),
    ("K1 resid_precond", ("resid_precond_kernel", "column_sum_kernel")),
    ("cuBLAS GEMMs", ("gemm", "gemv", "cutlass", "xmma", "cublas", "dot_")),
    ("linalg (eigh, cuSOLVER)", ("syev", "heev", "cusolver", "lapack",
                                 "potr", "trsm", "geqr", "orgqr")),
    ("cat / stack copies", ("CatArray", "cat_", "stack")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("memcpy / memset", ("Memcpy", "Memset", "memcpy", "memset")),
    ("eager elementwise", ("elementwise", "Elementwise")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


class Trace(NamedTuple):
    """Device and host events of one traced window, in ns."""
    start: int
    end: int
    device: list     # (name, start, end) of kernels, copies and sets
    host: list       # (name, start, end) on the window's host thread


def from_profiler(prof) -> Trace:
    """The window's events from a finished ``torch.profiler.profile`` whose
    window ran inside ``record_function(WINDOW)``."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW)
    start, end, tid = win.start_ns(), win.end_ns(), win.start_thread_id()
    device, host = [], []
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= start or s >= end:
            continue
        if e.device_type() == DeviceType.CUDA:
            # a record_function's range is mirrored on the device as an
            # annotation: it is no operation
            if e.name() != WINDOW and not e.is_user_annotation():
                device.append((e.name(), s, t))
        elif e.start_thread_id() == tid and e.name() != WINDOW:
            host.append((e.name(), s, t))
    return Trace(start, end, device, host)


def union(trace: Trace) -> list:
    """Merged (start, end) device-busy intervals, clipped to the window."""
    out = []
    for _, s, t in sorted(trace.device, key=lambda d: d[1]):
        s, t = max(s, trace.start), min(t, trace.end)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(trace: Trace) -> float:
    return sum(t - s for s, t in union(trace)) / 1e9


def window_s(trace: Trace) -> float:
    return (trace.end - trace.start) / 1e9


def device_s(trace: Trace, keys=None) -> dict:
    """Device seconds by family (``keys`` None) or summed over the events
    whose name holds any of ``keys`` (key "total")."""
    out = collections.defaultdict(float)
    for name, s, t in trace.device:
        if keys is None:
            out[family(name)] += (t - s) / 1e9
        elif any(k in name for k in keys):
            out["total"] += (t - s) / 1e9
    return dict(out)


def gaps(trace: Trace) -> list:
    """Idle (start, end) intervals of the device inside the window."""
    out, last = [], trace.start
    for s, t in union(trace):
        if s > last:
            out.append((last, s))
        last = max(last, t)
    if trace.end > last:
        out.append((last, trace.end))
    return out


def _host_at(host: list, starts: list, ends_max: list, ts: int) -> str:
    """The innermost host event spanning ``ts`` (the latest-starting one
    that has not ended), named with the runtime call inside it if any."""
    i = bisect.bisect_right(starts, ts) - 1
    names, stop = [], max(-1, i - MAX_SCAN)
    while i > stop and ends_max[i] >= ts and len(names) < 2:
        name, s, t = host[i]
        if s <= ts <= t:
            names.append(name)
        i -= 1
    if not names:
        return "host outside any operation"
    if names[0].startswith("cuda") and len(names) > 1:
        return f"{names[1]} | {names[0]}"
    return names[0]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The ``breakdown`` of a traced result line: the device operations
    that took most time and the idle gaps summed by what the host was
    doing, each [[name, seconds], ...] with at most ``top`` entries."""
    ops = collections.defaultdict(float)
    for name, s, t in trace.device:
        ops[name[:NAME_CHARS]] += (t - s) / 1e9
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    ends_max, m = [], -1
    for h in host:
        m = max(m, h[2])
        ends_max.append(m)
    idle = collections.defaultdict(float)
    for s, t in gaps(trace):
        if t - s >= MIN_GAP_NS:
            key = _host_at(host, starts, ends_max, (s + t) // 2)
            idle[key[:NAME_CHARS]] += (t - s) / 1e9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
