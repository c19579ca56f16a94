"""The benchmark's own spans, and the reduction of one torch.profiler
trace (CPU and CUDA) to the numbers its readers take: device busy time,
the traced window, device time and record counts per kernel, the costliest
device operations and the idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    start: float     # perf_counter seconds
    end: float
    attrs: dict


class Spans:
    """Spans recorded by the benchmark around its calls into each layer,
    kept in memory."""

    def __init__(self):
        self.items: List[Span] = []

    def add(self, name: str, start: float, end: float, **attrs) -> None:
        self.items.append(Span(name, start, end, attrs))

    def of(self, name: str) -> List[Span]:
        return [s for s in self.items if s.name == name]


class TraceSummary(NamedTuple):
    window_s: float                      # host clock over the traced part
    busy_s: float                        # union of device activity
    kernel_s: Dict[str, float]           # device seconds by kernel name
    kernel_n: Dict[str, int]             # records by kernel name
    device_ops: List[Tuple[str, float]]  # costliest device ops
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host activity

    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and records of kernels whose name holds
        ``pattern``."""
        s = sum(v for k, v in self.kernel_s.items() if pattern in k)
        n = sum(v for k, v in self.kernel_n.items() if pattern in k)
        return s, n


def warm_up() -> None:
    """Start and stop the profiler once on a trivial operation: its first
    start in a process (loading and initializing CUPTI) takes seconds,
    which a traced window must not pay."""
    t = Tracer()
    t.start()
    import torch
    torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu")
    t.stop(reduce=False)
    t._prof = None


class Tracer:
    """One torch.profiler trace of CPU and CUDA activity between
    :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self._window = None
        self.summary: Optional[TraceSummary] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._window = None

    @property
    def running(self) -> bool:
        return self._prof is not None and self._window is None

    def stop(self, reduce: bool = True) -> Optional[TraceSummary]:
        """End the trace; with ``reduce`` also reduce it now, else later
        by :meth:`reduce` (the reduction takes seconds)."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        return self.reduce() if reduce else None

    def reduce(self) -> TraceSummary:
        """Reduce the raw events (the profiler's own parse into Python
        event trees takes minutes for a factor call's million events)."""
        raw = self._prof.profiler.kineto_results.events()
        self.summary = summarize(
            ((e.name(), str(e.device_type()), e.start_ns(),
              e.start_ns() + e.duration_ns()) for e in raw), self._window)
        self._prof = None
        return self.summary


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(events, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce a profiler's events, ``(name, device type, start ns, end
    ns)``: device intervals (kernels, copies, fills) merged into busy
    time, per-kernel sums, and each gap between device intervals charged
    to the CPU operation that last started before it."""
    dev, cpu = [], []
    for name, kind, a, b in events:
        if kind.endswith("CUDA"):
            dev.append((a, b, name))
        elif kind.endswith("CPU"):
            cpu.append((a, name))
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    for a, b, name in dev:
        kernel_s[name] += (b - a) * 1e-9
        kernel_n[name] += 1
    merged = _merge([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged) * 1e-9
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = defaultdict(float)
    for (a0, b0), (a1, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, (b0 + a1) / 2) - 1
        what = cpu[i][1] if i >= 0 else "(no host op)"
        gaps[what] += (a1 - b0) * 1e-9
    device_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=window_s, busy_s=busy,
                        kernel_s=dict(kernel_s), kernel_n=dict(kernel_n),
                        device_ops=[[k, v] for k, v in device_ops],
                        idle_gaps=[[k, v] for k, v in idle])


def kernel_device_s(summary: TraceSummary, pattern: str,
                    launches: int, notes: List[str]) -> Optional[float]:
    """Device seconds of the kernels named by ``pattern`` over the traced
    part, whose launches the program counted as ``launches``.  Where the
    trace holds fewer records than launches, the time is the mean device
    time per record times the launch count, and ``notes`` says so."""
    s, n = summary.kernel_time(pattern)
    if n == 0:
        return None
    if n < launches:
        notes.append(f"trace holds {n} of {launches} launches of "
                     f"{pattern}: its device time is the mean of a record "
                     f"times the launches")
        return s / n * launches
    return s
