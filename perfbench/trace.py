"""What a traced run reads: the device's operations from `torch.profiler`
(kernels and copies with their times) and the host's operations beside
them; and one reading of the card's own settings through `nvidia-smi`.
"""
from __future__ import annotations

import bisect
import subprocess
import time
from dataclasses import dataclass, field

SCAN = 4000        # host operations searched back from a gap's middle


@dataclass
class Interval:
    name: str
    start: float        # seconds on the profiler's clock
    end: float


@dataclass
class Trace:
    """The traced window's device operations and host operations, and its
    length in seconds."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_s: float = 0.0
    start: float = 0.0

    def busy_s(self):
        """Seconds in which at least one device operation ran."""
        busy, end = 0.0, None
        for iv in sorted(self.device, key=lambda i: i.start):
            s = max(iv.start, self.start)
            e = min(iv.end, self.start + self.window_s)
            if e <= s:
                continue
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def device_ops(self, n=10):
        """The device operations that took most time: [[name, seconds]]."""
        tot = {}
        for iv in self.device:
            tot[iv.name] = tot.get(iv.name, 0.0) + (iv.end - iv.start)
        return [[k[:120], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The device's idle time inside the window by what the host was
        doing at each gap's middle (the innermost host operation there):
        [[name, seconds]], the longest first."""
        ivs = sorted(self.device, key=lambda i: i.start)
        gaps, t = [], self.start
        for iv in ivs:
            if iv.start > t:
                gaps.append((t, min(iv.start, self.start + self.window_s)))
            t = max(t, iv.end)
        if t < self.start + self.window_s:
            gaps.append((t, self.start + self.window_s))
        host = sorted(self.host, key=lambda i: i.start)
        starts = [h.start for h in host]
        tot = {}
        for s, e in gaps:
            if e <= s:
                continue
            mid = (s + e) / 2
            inner = None
            # the innermost host operation covering the middle, among the
            # last SCAN operations that started before it
            for h in host[max(0, bisect.bisect_right(starts, mid) - SCAN):
                          bisect.bisect_right(starts, mid)]:
                if h.end >= mid and (inner is None
                                     or h.end - h.start
                                     < inner.end - inner.start):
                    inner = h
            name = inner.name if inner is not None else "(no host op)"
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[k[:120], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """`torch.profiler` over a part of a window: `start()`, `stop()`, then
    `trace()`. With no card it records the host only; with `host=False`
    the card alone (with no card, nothing)."""

    def __init__(self, torch, host=True):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if host else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.torch = torch
        self.host = host
        self.prof = profile(activities=acts) if acts else None
        self.t0 = self.t1 = None

    def start(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        if self.prof is not None:
            self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.stop()

    def trace(self):
        """The events as a `Trace`: device operations (kernels, copies,
        sets) and host operations, on the profiler's clock, and the
        window's length on the host's clock."""
        from torch.autograd import DeviceType
        tr = Trace(window_s=self.t1 - self.t0)
        if self.prof is None:
            return tr
        first = None
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e9
            iv = Interval(e.name(), s, s + e.duration_ns() / 1e9)
            if e.device_type() == DeviceType.CUDA:
                tr.device.append(iv)
            else:
                tr.host.append(iv)
                first = s if first is None else min(first, s)
        if not self.host:
            # the card alone: every device operation recorded belongs to
            # the part profiled (start() and stop() wait for the card), so
            # the part spans them all
            if tr.device:
                tr.start = min(iv.start for iv in tr.device)
                tr.window_s = max(iv.end for iv in tr.device) - tr.start
            tr.host = []
            return tr
        # the profiler's clock starts its first host event at about the
        # moment start() returned
        tr.start = first if first is not None else 0.0
        return tr


def smi_query(query):
    """One `nvidia-smi --query-gpu` reading of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None
