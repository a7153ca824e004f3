"""The traced slice of a `--trace 1` run, read from torch.profiler's own
event list (no trace file is written).

Spans are the `record_function` ranges that the benchmark's drivers open
around their calls into the program's layers. A device event (kernel,
memcpy, memset) is attributed to the innermost span that was open on the
host when the operation that launched it ran (its linked correlation id).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def span(name: str):
    """A benchmark span around a call into the program."""
    return torch.profiler.record_function(name)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    span: Optional[str]  # the innermost benchmark span at its launch
    kernel: bool  # False for memcpy / memset

    @property
    def function(self) -> str:
        """A kernel's function name, without its return type, namespace,
        template arguments and parameters."""
        name = self.name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0].strip()
        return name.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


@dataclasses.dataclass
class TraceData:
    windows: List[Tuple[int, int]]  # the traced slices, ns on the profiler's clock
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, int]]  # (name, start, end) on the host, profiler clock
    unlinked: int  # device events whose launch could not be placed
    parents: List[int] = dataclasses.field(default_factory=list)
    read_s: float = 0.0  # host seconds spent reading the profiler's events

    @property
    def window_s(self) -> float:
        """The traced slices' length, together."""
        return sum(b - a for a, b in self.windows) / 1e9

    def busy_s(self, ops: Optional[Iterable[DeviceOp]] = None) -> float:
        """Seconds in the slices in which one of `ops` (all) ran."""
        busy = _union([(o.start, o.end) for o in (self.ops if ops is None else ops)])
        return sum(max(0, min(b, w1) - max(a, w0)) for w0, w1 in self.windows for a, b in busy) / 1e9

    def under(self, *prefixes: str) -> List[DeviceOp]:
        """The device events launched under a span whose name starts with
        one of `prefixes`."""
        return [o for o in self.ops if o.span is not None and o.span.startswith(prefixes)]

    def device_s(self, *prefixes: str) -> float:
        return self.busy_s(self.under(*prefixes))

    def kernels(self) -> int:
        return sum(o.kernel for o in self.ops)

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            total[o.name] += (o.end - o.start) / 1e9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time between device operations, summed by the innermost
        span open on the host at each gap's middle, most first."""
        busy = _union([(o.start, o.end) for o in self.ops])
        starts = [s for _, s, _ in self.spans]
        by: Dict[str, float] = defaultdict(float)
        for w0, w1 in self.windows:
            edges = [w0] + [x for ab in busy if ab[1] > w0 and ab[0] < w1 for x in ab] + [w1]
            for a, b in zip(edges[0::2], edges[1::2]):
                a, b = max(a, w0), min(b, w1)
                if b > a:
                    by[self._span_at((a + b) // 2, starts) or "no span"] += (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _span_at(self, t: int, starts: List[int]) -> Optional[str]:
        """The innermost span open at t: the last one to start at or before
        t, or the nearest of its enclosing spans that is still open."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            name, a, b = self.spans[i]
            if b >= t:
                return name
            i = self.parents[i]
        return None


def _parents(spans: List[Tuple[str, int, int]]) -> List[int]:
    """For spans sorted by start and nested (one host thread), the index of
    each one's enclosing span, -1 at the top."""
    out, stack = [], []
    for i, (_, a, b) in enumerate(spans):
        while stack and spans[stack[-1]][2] < a:
            stack.pop()
        out.append(stack[-1] if stack else -1)
        stack.append(i)
    return out


WINDOW = "bench.window"


def merged(slices: List[TraceData]) -> TraceData:
    spans = sorted((sp for t in slices for sp in t.spans), key=lambda sp: sp[1])
    return TraceData(windows=[w for t in slices for w in t.windows], ops=[o for t in slices for o in t.ops],
                     spans=spans, unlinked=sum(t.unlinked for t in slices), parents=_parents(spans),
                     read_s=sum(t.read_s for t in slices))


class Tracer:
    """torch.profiler over CPU and CUDA between `start()` and `stop()`, each
    slice one WINDOW span; a driver may stop and start it again inside a
    unit of work to trace part of it. `data` is every slice's, merged."""

    def __init__(self, prefixes: Tuple[str, ...], cuda: bool = True):
        self.prefixes = prefixes
        self.cuda = cuda
        self.prof = None
        self.window = None
        self.slices: List[TraceData] = []

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def data(self) -> Optional[TraceData]:
        return merged(self.slices) if self.slices else None

    def start(self) -> None:
        if self.active:
            return
        acts = [torch.profiler.ProfilerActivity.CPU] + [torch.profiler.ProfilerActivity.CUDA] * self.cuda
        self.prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
        self.prof.__enter__()
        self._sync()
        self.window = span(WINDOW)
        self.window.__enter__()

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        data = read(self.prof, self.prefixes)
        data.read_s = time.perf_counter() - t0
        self.slices.append(data)
        self.prof = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def read(prof, prefixes: Tuple[str, ...]) -> TraceData:
    """TraceData from a stopped torch.profiler.profile whose slice is the
    WINDOW span. A device event is placed by its launch: the runtime call
    (cudaLaunchKernel, cudaGraphLaunch, a memcpy) that shares its
    correlation id, whose time on the host falls in the innermost span open
    then; failing that, by the operator it is linked to."""
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    front: Dict[int, int] = {}  # operator id -> start
    launches: Dict[int, int] = {}  # runtime call's correlation id -> start
    spans, device, window = [], [], None
    for e in events:
        if e.device_type() == cpu:
            name = e.name()
            if e.is_user_annotation():
                if name == WINDOW:
                    window = (e.start_ns(), e.end_ns())
                elif name.startswith(prefixes):
                    spans.append((name, e.start_ns(), e.end_ns()))
            elif name.startswith(("cuda", "cu")):  # a runtime or driver call: the launch's correlation id
                launches[e.correlation_id()] = e.start_ns()
            else:
                front[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append(e)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    spans.sort(key=lambda s: s[1])
    starts = [s for _, s, _ in spans]
    td = TraceData(windows=[window], ops=[], spans=spans, unlinked=0, parents=_parents(spans))
    for e in device:
        name = e.name()
        at = launches.get(e.correlation_id())
        if at is None and e.linked_correlation_id() > 0:
            at = front.get(e.linked_correlation_id())
        if at is None:
            td.unlinked += 1
        kernel = not name.startswith(("Memcpy", "Memset"))
        where = None if at is None else td._span_at(at, starts)
        td.ops.append(DeviceOp(name, e.start_ns(), e.start_ns() + e.duration_ns(), where, kernel))
    return td
