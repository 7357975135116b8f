"""Reading the traced window: the profiler's events and the harness's
timings of the device passes and replies.

:func:`capture` runs ``torch.profiler`` (CPU and CUDA activity) over a
block and parses its Chrome trace into plain lists on the profiler's
clock, in seconds:

  * ``device``: ``(t0, t1, name, cat, correlation)`` of every kernel,
    copy and memset;
  * ``launch``: ``{correlation: (tid, t)}`` of the host calls that
    launched them;
  * ``ranges``: ``(name, tid, t0, t1)`` of ``record_function`` ranges
    (the window's marks);
  * ``window``: the traced window, between the two ``portbench.mark``
    ranges, and ``offset``: profiler clock minus ``time.perf_counter``
    (so the host's timings can be laid over the device's timeline).

The helpers below reduce those lists; the metric readers call them.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK = "portbench.mark"


def _mark(torch):
    t_a = time.perf_counter()
    with torch.profiler.record_function(MARK):
        pass
    return (t_a + time.perf_counter()) / 2


@contextlib.contextmanager
def capture(out: dict, cuda: bool = True):
    """Profile the block (the card's activity too with ``cuda``); fill
    ``out`` with the parsed lists on exit."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        p0 = _mark(torch)
        yield
        if cuda:
            torch.cuda.synchronize()
        p1 = _mark(torch)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out.update(parse(path, (p0, p1)))
    finally:
        os.unlink(path)


def parse(path: str, marks=None) -> dict:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, launch, ranges = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        t0 = float(ev.get("ts", 0.0)) / 1e6
        t1 = t0 + float(ev.get("dur", 0.0)) / 1e6
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((t0, t1, ev.get("name", ""), cat,
                           args.get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = args.get("correlation")
            if corr is not None:
                launch[corr] = (ev.get("tid"), t0)
        elif cat == "user_annotation":
            ranges.append((ev.get("name", ""), ev.get("tid"), t0, t1))
    marks_at = sorted((r[2] + r[3]) / 2 for r in ranges if r[0] == MARK)
    out = {"device": device, "launch": launch, "ranges": ranges,
           "window": None, "offset": None}
    if len(marks_at) >= 2:
        out["window"] = (marks_at[0], marks_at[-1])
        if marks is not None:
            out["offset"] = marks_at[0] - marks[0]
    return out


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_intervals(prof: dict) -> list:
    """Merged intervals, inside the window, in which a kernel, copy or
    memset ran."""
    w0, w1 = prof["window"]
    clipped = [(max(a, w0), min(b, w1)) for a, b, *_ in prof["device"]
               if b > w0 and a < w1]
    return _union(clipped)


def busy_s(prof: dict) -> float:
    return sum(b - a for a, b in busy_intervals(prof))


def window_s(prof: dict) -> float:
    w0, w1 = prof["window"]
    return w1 - w0


def idle_gaps(prof: dict) -> list:
    """``(t0, t1)`` of the device's idle stretches inside the window."""
    w0, w1 = prof["window"]
    gaps, t = [], w0
    for a, b in busy_intervals(prof):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def engine_kernels(prof: dict, calls) -> tuple:
    """``(kernels, unattributed)``: the kernels launched while one of the
    device passes ``calls`` (``(t0, t1, ...)`` on ``time.perf_counter``)
    ran (only the service's dispatcher launches work on the card), and
    the count of kernels whose launch the trace does not show."""
    off = prof.get("offset") or 0.0
    calls = _union((a + off, b + off) for a, b, *_ in calls)
    starts = [a for a, _b in calls]
    got, lost = [], 0
    for ev in prof["device"]:
        if ev[3] != "kernel":
            continue
        hit = prof["launch"].get(ev[4])
        if hit is None:
            lost += 1
            continue
        i = bisect.bisect_right(starts, hit[1]) - 1
        if i >= 0 and hit[1] <= calls[i][1]:
            got.append(ev)
    return got, lost


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        at = name.find(cut)
        if at > 0:
            name = name[:at]
    return name.strip()


def top_device_ops(prof: dict, n: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time inside the window, summed by name."""
    w0, w1 = prof["window"]
    tot: dict = {}
    for a, b, name, _cat, _c in prof["device"]:
        if b > w0 and a < w1:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + (min(b, w1) - max(a, w0))
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def labelled_gaps(prof: dict, timing: dict, n: int = 10) -> list:
    """``[[what the host did, seconds], ...]``: the longest idle gaps,
    each named by the timed stretch (``timing``'s ``dispatch`` or
    ``reply``) that overlaps it most ("queue" when none does: the
    dispatcher waited for requests)."""
    off = prof.get("offset") or 0.0
    spans = [(name, a + off, b + off) for name in ("dispatch", "reply")
             for a, b, *_ in (timing or {}).get(name, ())]
    out = []
    for a, b in sorted(idle_gaps(prof), key=lambda g: g[0] - g[1])[:n]:
        best, what = 0.0, "queue"
        for name, s0, s1 in spans:
            ov = min(b, s1) - max(a, s0)
            if ov > best:
                best, what = ov, name
        out.append([what, b - a])
    return out
