"""The traced run: the inputs of each kernel launch counted for the
rooflines, and the reduction of the profiler's events to device busy
time, time by device operation and idle gaps by host range (the
program's own `stage.<name>` ranges, which it opens while a profiler
records, and the harness's `bench.*`).  Nothing here runs unless
`--trace 1`."""

from __future__ import annotations

import re
from contextlib import contextmanager


@contextmanager
def launch_hooks(hooks: dict, sink: dict):
    """Wrap each launcher `module:function` of `hooks` (metric name ->
    {target: count function}) so that every call first appends
    `count(*args, **kw)` to `sink[metric]`."""
    import importlib
    saved = []
    for metric, targets in hooks.items():
        for target, count in targets.items():
            mod_name, fn_name = target.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            bucket = sink.setdefault(metric, [])

            def wrapper(*a, _orig=orig, _count=count, _bucket=bucket, **kw):
                _bucket.append(_count(*a, **kw))
                return _orig(*a, **kw)

            saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, wrapper)
    try:
        yield
    finally:
        for mod, fn_name, orig in reversed(saved):
            setattr(mod, fn_name, orig)


def resolve(value):
    """Counts recorded as device tensors, read after the window."""
    import torch
    if isinstance(value, dict):
        return {k: resolve(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [resolve(v) for v in value]
    if torch.is_tensor(value):
        return float(value.item())
    return value


def clean_name(name: str, n: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.:<>-]+", "_", name)[:n]


def reduce_events(events, t_lo_us: float, t_hi_us: float) -> dict:
    """From the profiler's events: the union of device activity inside
    [t_lo, t_hi] (busy seconds); device seconds by operation name inside
    it, and over the whole profile (every launch of the window runs
    inside the profile, which opens and closes on a synchronised card);
    and the idle gaps between device activity, spread over the innermost
    host ranges (`stage.*`, `bench.*`) open during them."""
    from torch.autograd import DeviceType
    dev, ranges = [], []
    by_name: dict[str, float] = {}
    all_by_name: dict[str, float] = {}
    for e in events:
        tr = e.time_range
        # a host range also shows on the device's timeline as an
        # annotation: it is not device work
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.name.startswith(("stage.", "bench.")))
        if e.device_type == DeviceType.CUDA and not annotation:
            all_by_name[e.name] = (all_by_name.get(e.name, 0.0)
                                   + (tr.end - tr.start) / 1e6)
            lo, hi = max(tr.start, t_lo_us), min(tr.end, t_hi_us)
            if hi > lo:
                dev.append((lo, hi))
                by_name[e.name] = by_name.get(e.name, 0.0) + (hi - lo) / 1e6
        elif e.device_type != DeviceType.CUDA and \
                e.name.startswith(("stage.", "bench.")):
            ranges.append((tr.start, tr.end, e.name))
    dev.sort()
    busy, gaps = 0.0, []
    cur_lo = cur_hi = None
    last_end = t_lo_us
    for lo, hi in dev:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
                last_end = cur_hi
            if lo > last_end:
                gaps.append((last_end, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
        last_end = cur_hi
    if t_hi_us > last_end:
        gaps.append((last_end, t_hi_us))
    return {"busy_s": busy / 1e6, "by_name": by_name,
            "all_by_name": all_by_name,
            "idle_by_range": _attribute(gaps, ranges)}


def _attribute(gaps, ranges) -> dict:
    """Seconds of device idleness under each host range: every stretch
    of a gap goes to the innermost (shortest) range open over it, or to
    `host.other` where none is."""
    import heapq
    marks = []
    for lo, hi in gaps:
        marks += [(lo, 0, "gap+", None), (hi, 0, "gap-", None)]
    for k, (lo, hi, name) in enumerate(ranges):
        marks += [(lo, 1, "open", (hi - lo, k, name)),
                  (hi, 1, "close", k)]
    marks.sort(key=lambda m: (m[0], m[1]))
    out: dict[str, float] = {}
    heap, closed = [], set()
    in_gap, last = 0, None
    for t, _, kind, val in marks:
        if last is not None and in_gap and t > last:
            while heap and heap[0][1] in closed:
                heapq.heappop(heap)
            key = heap[0][2] if heap else "host.other"
            out[key] = out.get(key, 0.0) + (t - last) / 1e6
        last = t
        if kind == "gap+":
            in_gap += 1
        elif kind == "gap-":
            in_gap -= 1
        elif kind == "open":
            heapq.heappush(heap, val)
        else:
            closed.add(val)
    return out


def top(d: dict, n: int = 10) -> list:
    return [[clean_name(k), v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
