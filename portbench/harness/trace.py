"""Reduce one ``torch.profiler`` session to intervals, busy time, idle
gaps and the breakdown.

``busy_us`` is a frozen copy of ``tools/torch_ab.py::_busy_us``: the union
of the device's kernel, copy and set intervals, taken here over
``(start, end)`` pairs clipped to the traced window, so that the idle
share is 1 - busy / window."""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.call"


def busy_us(spans) -> float:
    """Union of ``(start, end)`` intervals, in their unit (us)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merged(spans) -> list:
    """The union of the intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(busy_spans, lo: float, hi: float) -> list:
    """The idle intervals of ``[lo, hi]`` between merged busy intervals."""
    out, t = [], lo
    for s, e in busy_spans:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def _short(name: str) -> str:
    """A device operation's name without namespaces' noise, return type and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].strip()
    return head[5:] if head.startswith("void ") else head


class Trace:
    """What the readers see of one traced window, from the events of the
    profiler's Chrome trace: device intervals by name (kernels, copies and
    sets; not the device-side copies of annotations), the window, busy
    time, and the host's innermost span over each idle gap."""

    def __init__(self, events):
        self.device = []  # (short name, start us, end us)
        host = []
        window = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((_short(e.get("name", "")), s, t))
            elif not cat.startswith("gpu_"):
                if e.get("name") == WINDOW_SPAN and cat == "user_annotation":
                    window = (s, t, e.get("tid"))
                host.append((s, t, e.get("name", ""), e.get("tid")))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        self.lo, self.hi, thread = window
        self.host = sorted((h for h in host if h[3] == thread and h[2] != WINDOW_SPAN), key=lambda h: (h[0], -h[1]))
        self._starts = [h[0] for h in self.host]
        clipped = [(max(s, self.lo), min(t, self.hi)) for _, s, t in self.device if t > self.lo and s < self.hi]
        self.busy = merged(clipped)
        self.busy_us = busy_us(clipped)
        self.window_us = self.hi - self.lo

    def device_us(self, match) -> float:
        """Summed device time of the intervals whose short name satisfies
        ``match``, inside the window."""
        return sum(min(t, self.hi) - max(s, self.lo) for n, s, t in self.device
                   if match(n) and t > self.lo and s < self.hi)

    def spans(self, name: str) -> list:
        """``(start, end)`` of the host spans named ``name`` in the window."""
        return [(s, e) for s, e, n, _ in self.host if n == name]

    def first_in_each(self, spans, match) -> list:
        """For each ``(start, end)`` span, the duration (us) of the first
        device interval whose short name satisfies ``match`` and that
        starts inside the span; spans with none are left out."""
        found = sorted((s, t) for n, s, t in self.device if match(n))
        starts = [s for s, _ in found]
        out = []
        for a, b in spans:
            j = bisect.bisect_left(starts, a)
            if j < len(found) and found[j][0] < b:
                out.append(found[j][1] - found[j][0])
        return out

    def device_ops(self, top: int = 10) -> list:
        """Device seconds in the window by operation name, the largest
        first."""
        acc = defaultdict(float)
        for n, s, t in self.device:
            if t > self.lo and s < self.hi:
                acc[n] += (min(t, self.hi) - max(s, self.lo)) / 1e6
        return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def host_at(self, t: float) -> str:
        """The innermost host span open at ``t``: of those that started by
        ``t`` and end after it, the latest to start."""
        j = bisect.bisect_right(self._starts, t) - 1
        while j >= 0:
            s, e, n, _ = self.host[j]
            if e >= t:
                return n
            j -= 1
        return WINDOW_SPAN

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds of the window by the innermost host span open at
        the middle of each gap, the largest first."""
        acc = defaultdict(float)
        for a, b in gaps(self.busy, self.lo, self.hi):
            acc[self.host_at((a + b) / 2)] += (b - a) / 1e6
        return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def read_profile(prof, tmpdir=None) -> Trace:
    """The Trace of a finished ``torch.profiler`` session (its Chrome trace
    goes through a temporary file, deleted at once)."""
    import json
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)
