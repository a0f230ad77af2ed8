"""What a ``--trace 1`` run reads over its window: the device's activity
from ``torch.profiler`` (CUPTI), and the program's own spans, drained from
its tracer (``filodb_tpu_torch.utils.tracing``) often enough that its ring
loses none. The readers in ``metrics/`` take their numbers from a
:class:`RunView`.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

from .stats import attribute, busy_ns, merged

DRAIN_EVERY_S = 0.05
TOP = 10


@dataclass
class DeviceTrace:
    """The device's activities over the traced window, sorted by start:
    ``(name, start_ns, end_ns)``; ``families`` gives each one's
    hand-written kernel family (None for any other)."""
    kernels: list
    families: list
    window_s: float
    busy_s: float
    spans: list = field(default_factory=list)
    spans_lost: int = 0
    gaps: list = field(default_factory=list)

    def breakdown(self) -> dict:
        by_name: dict = collections.Counter()
        for name, s, e in self.kernels:
            by_name[name] += (e - s) / 1e9
        return {"device_ops": [[n, v] for n, v in by_name.most_common(TOP)],
                "idle_gaps": [[label, s] for s, label in self.gaps[:TOP]]}


@dataclass
class RunView:
    cell: str
    cfg: dict
    traffic: dict
    ranges: list
    requests: list
    window: tuple
    counters: dict
    device: DeviceTrace | None

    @property
    def n_requests(self) -> int:
        return len(self.requests)


def _innermost(spans, t_us: float) -> collections.Counter:
    """The innermost span of each trace in flight at ``t_us``, by name."""
    best: dict = {}
    for sp in spans:
        if sp.start_us <= t_us < sp.start_us + sp.duration_us:
            cur = best.get(sp.trace_id)
            if cur is None or sp.start_us >= cur.start_us:
                best[sp.trace_id] = sp
    return collections.Counter(sp.name for sp in best.values())


def name_gaps(busy, w0_ns: int, w1_ns: int, spans) -> list:
    """The window's idle stretches, longest first, as (seconds, what the
    host was doing): the program's innermost spans open at the stretch's
    middle, by how many queries were in each."""
    edges = [w0_ns] + [x for s, e in busy for x in (s, e)] + [w1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:TOP]:
        inner = _innermost(spans, (s + e) / 2000.0)
        label = ", ".join(f"{n} x{c}" for n, c in inner.most_common(3)) \
            or "no query span open"
        out.append(((e - s) / 1e9, label))
    return out


class Collector:
    """Opened when the window opens; :meth:`tick` drains the tracer while
    the clients run; :meth:`finish` stops the profiler once the last
    request of the window is answered."""

    def __init__(self, device):
        from filodb_tpu_torch.utils.tracing import tracer
        self.tracer = tracer
        self.on_card = device.type == "cuda"
        self.prof = None
        self.spans: list = []
        self._last = 0.0

    def open(self) -> None:
        self.tracer.drain()             # the warm-up's spans are not read
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        self.wall0 = time.time_ns()
        self.t0 = time.perf_counter()

    def tick(self) -> None:
        now = time.perf_counter()
        if now - self._last >= DRAIN_EVERY_S:
            self._last = now
            self.spans.extend(self.tracer.drain())

    def finish(self) -> DeviceTrace:
        window_s = time.perf_counter() - self.t0
        wall1 = time.time_ns()
        self.spans.extend(self.tracer.drain())
        kernels = []
        if self.prof is not None:
            import torch
            self.prof.stop()
            cuda = torch.autograd.DeviceType.CUDA
            for ev in self.prof.profiler.kineto_results.events():
                if ev.device_type() == cuda:
                    s = ev.start_ns()
                    kernels.append((ev.name(), s, s + ev.duration_ns()))
        kernels.sort(key=lambda k: k[1])
        seqs = sorted(sp.seq for sp in self.spans)
        lost = (seqs[-1] - seqs[0] + 1 - len(seqs)) if seqs else 0
        busy = merged((s, e) for _, s, e in kernels)
        tr = DeviceTrace(kernels, attribute(kernels), window_s,
                         busy_ns(busy) / 1e9, self.spans, lost)
        # the profiler's clock is the host's wall clock when every
        # activity lies inside the window by it: only then are spans and
        # idle stretches set side by side
        if kernels and self.wall0 <= kernels[0][1] \
                and kernels[-1][2] <= wall1:
            tr.gaps = name_gaps(busy, self.wall0, wall1, self.spans)
        return tr
