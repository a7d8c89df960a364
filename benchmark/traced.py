"""The profiled stretch of a traced run, read once after the window.

Device time is attributed to the program's ``record_function`` ranges
(and the encoder ranges the benchmark's forward hooks open) through
their device-side spans, by the arithmetic of
:mod:`benchmark.frozen.spans`.  A range's device span runs from the
first to the last kernel launched directly in it; kernels launched in a
range nested in it belong to the nested range's span.  The profiled
iterations are counted by the harness's ``bench_iteration`` host
ranges."""

from collections import defaultdict

from torch.autograd import DeviceType

from benchmark.frozen.spans import busy_in, device_kernels, ranges

ITERATION_RANGE = "bench_iteration"
TOP = 10


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, prof, device):
        events = list(prof.events())
        host_names = {e.name for e in events
                      if e.device_type == DeviceType.CPU}
        dev_names = {e.name for e in events
                     if e.device_type == DeviceType.CUDA}
        # a range shows on both sides; a kernel only on the device
        self.range_names = host_names & dev_names
        self.host, self.spans = ranges(events, self.range_names)
        self.kernels = device_kernels(events, self.range_names)
        self._cpu = [(e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.device_type == DeviceType.CPU]
        self.n_iterations = len(self.host.get(ITERATION_RANGE, []))
        # the stretch: every kernel the session recorded, the profiled
        # iterations'; a range's own device span holds only the kernels
        # launched directly in it, not in the ranges nested in it, so the
        # iterations' range cannot bound it
        self.stretch = (self.kernels[0][1],
                        max(b for _, _, b in self.kernels)) \
            if self.kernels else None
        self._busy = self._clipped_union()

    def _clipped_union(self):
        if self.stretch is None:
            return []
        s, e = self.stretch
        return _union((max(a, s), min(b, e)) for _, a, b in self.kernels
                      if b > s and a < e)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e6

    @property
    def window_s(self) -> float:
        return 0.0 if self.stretch is None else \
            (self.stretch[1] - self.stretch[0]) / 1e6

    def busy_ms(self, names) -> float | None:
        """Device ms an iteration of the kernels that start in the device
        spans of the ranges ``names``; None where none of them ran."""
        spans = [iv for n in names for iv in self.spans.get(n, [])]
        if not spans or not self.n_iterations:
            return None
        return busy_in(self.kernels, spans) / 1e3 / self.n_iterations

    def between_ms(self, first: str, second: str) -> float | None:
        """Device ms an iteration of the kernels that start after the end
        of each span of ``first`` and before the start of the next span of
        ``second``."""
        a = sorted(self.spans.get(first, []))
        b = sorted(self.spans.get(second, []))
        if not a or not b or not self.n_iterations:
            return None
        gaps = []
        for _, end in a:
            nxt = [s for s, _ in b if s >= end]
            if nxt:
                gaps.append((end, min(nxt)))
        if not gaps:
            return None
        return busy_in(self.kernels, gaps) / 1e3 / self.n_iterations

    def _host_doing(self, t: float) -> str:
        inner = [(a, n) for a, b, n in self._cpu
                 if a <= t < b and n != ITERATION_RANGE]
        named = [(a, n) for a, n in inner if n in self.range_names]
        what = max(inner)[1] if inner else "no host op"
        where = max(named)[1] if named else ""
        return f"{what} in {where}" if where and where != what else what

    def breakdown(self) -> dict:
        """The device operations that took most time in the stretch, and
        the longest idle gaps, each named by what the host was doing at
        the gap's middle."""
        if self.stretch is None:
            return {"device_ops": [], "idle_gaps": []}
        s, e = self.stretch
        by_name = defaultdict(float)
        for name, a, b in self.kernels:
            if s <= a < e:
                by_name[name] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, prev = [], s
        for a, b in self._busy:
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = max(prev, b)
        if e > prev:
            gaps.append((e - prev, prev, e))
        gaps.sort(reverse=True)
        idle = [[self._host_doing((a + b) / 2)[:160], d / 1e6]
                for d, a, b in gaps[:TOP]]
        return {"device_ops": [[n[:160], t] for n, t in ops],
                "idle_gaps": idle}
