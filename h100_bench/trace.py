"""The reduction from a ``torch.profiler`` trace to the benchmark's numbers.

The harness traces a stretch of the window's solves. Each solve runs inside
a host span named ``bench.solve`` that ends in ``torch.cuda.synchronize()``.
A device event belongs to the span in which the host launched it: the
runtime call that launched it carries the event's correlation id, and its
start time falls inside the span. So do the harness's own spans around
calls into a layer (``bench.spmv`` around the generic tier's matvec).

Busy time is the length of the union of the device intervals (kernels,
copies and sets), the arithmetic of ``profile_port.py``'s ``busy_us``.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "bench."
SOLVE = "bench.solve"
#: characters of a kernel's name kept in the breakdown
NAME_CHARS = 160


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    start: float  # µs
    end: float  # µs
    spans: frozenset  # the harness's spans (other than the solve) it is in

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Stretch:
    """The traced solves, reduced."""

    solves: List[List[DeviceEvent]]  # each solve's device events, by start
    spans: Dict[str, List[Tuple[float, float]]]  # host spans by name
    window_us: float  # first solve's start to the last one's end
    busy_us: float  # union of the device intervals inside the window
    breakdown: dict


def busy_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(spans: Sequence[Tuple[float, float]], t: float) -> bool:
    """Whether t lies in one of the sorted, disjoint ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def _gaps(busy: List[List[float]], w0: float, w1: float):
    """The stretches of [w0, w1] that no interval of ``busy`` covers."""
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, w1)))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return [g for g in gaps if g[1] > g[0]]


def name_gaps(gaps, host: Sequence[Tuple[str, float, float]], top: int = 10):
    """The ``top`` longest ``gaps``, each named by the shortest host event
    that covers its middle (what the host was doing), as ``[name,
    seconds]``."""
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        best: Optional[Tuple[str, float, float]] = None
        for ev in host:
            if ev[1] <= mid <= ev[2] and (
                    best is None or ev[2] - ev[1] < best[2] - best[1]):
                best = ev
        out.append([f"host: {best[0]}" if best else "host: none",
                    (e - s) / 1e6])
    return out


def device_ops(events: Sequence[DeviceEvent], top: int = 10):
    """``[name, seconds]`` of the device operations that took most time."""
    by_name: Dict[str, float] = defaultdict(float)
    for ev in events:
        by_name[ev.name[:NAME_CHARS]] += ev.dur
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[name, us / 1e6] for name, us in ranked]


def reduce_events(raw_device: Sequence[Tuple[str, float, float, int, int]],
                  raw_host: Sequence[Tuple[str, float, float, int, int]]
                  ) -> Stretch:
    """Reduce a trace. ``raw_device`` holds ``(name, start, end, id,
    link)`` and ``raw_host`` ``(name, start, end, id, link)``, times in µs.
    A device event's host launch is the runtime call (a host event whose
    name starts with ``cu``) with the event's id, its correlation; failing
    that, the framework operation its ``link`` names; failing both, its own
    start. The window is the solves' spans: what the harness does between
    calls (drawing b, copying a checked answer) is neither busy nor
    idle."""
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    runtime, frontend = {}, {}
    for name, s, e, ident, link in raw_host:
        if name.startswith(SPAN_PREFIX):
            spans[name].append((s, e))
        if name.startswith("cu"):
            runtime[ident] = s
        elif ident and not link:
            frontend[ident] = s
    for name in spans:
        spans[name].sort()
    solve_spans = spans.get(SOLVE, [])
    others = {n: v for n, v in spans.items() if n != SOLVE}
    solves: List[List[DeviceEvent]] = [[] for _ in solve_spans]
    for name, s, e, ident, link in raw_device:
        if name.startswith(SPAN_PREFIX):
            continue  # the device's copy of a host span, not an operation
        launched = runtime.get(ident, frontend.get(link, s))
        i = bisect.bisect_right(solve_spans, (launched, float("inf"))) - 1
        if i < 0 or launched > solve_spans[i][1]:
            continue
        tags = frozenset(n for n, v in others.items() if _inside(v, launched))
        solves[i].append(DeviceEvent(name, s, e, tags))
    for events in solves:
        events.sort(key=lambda ev: ev.start)
    window = sum(e - s for s, e in solve_spans)
    busy, gaps, inside = 0.0, [], []
    host = [(n, s, e) for n, s, e, _, _ in raw_host]
    for (w0, w1), events in zip(solve_spans, solves):
        clipped = [(max(ev.start, w0), min(ev.end, w1)) for ev in events
                   if ev.end > w0 and ev.start < w1]
        busy += busy_us(clipped)
        gaps.extend(_gaps(merged(clipped), w0, w1))
        inside.extend(events)
    breakdown = {"device_ops": device_ops(inside),
                 "idle_gaps": name_gaps(gaps, host)} if solve_spans else {}
    return Stretch(solves=solves, spans=dict(spans), window_us=window,
                   busy_us=busy, breakdown=breakdown)


def reduce_profile(prof) -> Stretch:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.events():
        r = ev.time_range
        row = (ev.name, r.start, r.end, int(ev.id or 0),
               int(getattr(ev, "linked_correlation_id", 0) or 0))
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append(row)
        elif ev.device_type == DeviceType.CPU:
            host.append(row)
    return reduce_events(device, host)


def per_solve_us(solves: Sequence[Sequence[DeviceEvent]], pick) -> Optional[
        List[float]]:
    """Each solve's device µs in the events that ``pick`` takes; None where
    no solve has one."""
    times = [sum(ev.dur for ev in s if pick(ev)) for s in solves]
    hit = any(pick(ev) for s in solves for ev in s)
    return times if hit else None


def name_has(*parts: str):
    """A pick of the events whose lower-cased name holds one of ``parts``."""
    low = tuple(p.lower() for p in parts)
    return lambda ev: any(p in ev.name.lower() for p in low)
