"""The reduction of a ``torch.profiler`` trace to device times, spans and
idle gaps (``kernel_kind`` is ``chip_smoke.py``'s ``_kernel_kind``).

A :class:`Trace` holds the device operations (kernels, copies, fills) as
``(name, start_us, end_us)`` and the benchmark's own host spans
(``record_function("portbench.*")``) as ``(name, start_us, end_us)``, on
the profiler's one clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

SPAN_PREFIX = "portbench."
STEP_SPAN = SPAN_PREFIX + "step"

ATTENTION, SSD, NORM, GEMM, OTHER = (
    "attention kernels",
    "ssd kernels",
    "norm kernels",
    "GEMMs",
    "other (elementwise, reductions, copies, cross_entropy)",
)


def kernel_kind(name: str) -> str:
    # flash_attention.cu: flash_*_kernel (f32), flash_tc::* (bf16), delta_kernel
    if "flash_" in name or "delta_kernel" in name:
        return ATTENTION
    if "ssd_" in name:
        return SSD
    if any(s in name for s in ("norm_kernel", "norm_bwd_kernel", "partial_reduce_kernel")):
        return NORM
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return GEMM
    return OTHER


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float, float]]  # device operations
    spans: List[Tuple[str, float, float]]  # the benchmark's host spans

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        ops, spans = [], []
        for e in prof.events():
            r = e.time_range
            if e.device_type == DeviceType.CUDA:
                # a host span's mirror on the device timeline covers its gaps: not an operation
                annotation = getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
                if r.end > r.start and not annotation:
                    ops.append((e.name, float(r.start), float(r.end)))
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((e.name, float(r.start), float(r.end)))
        return cls(ops, spans)

    def window(self) -> Tuple[float, float]:
        """The traced window: from the first step span's start to the last
        one's end (us)."""
        steps = [(s, e) for n, s, e in self.spans if n == STEP_SPAN]
        if not steps:
            raise ValueError("no step span in the trace")
        return min(s for s, _ in steps), max(e for _, e in steps)

    def n_steps(self) -> int:
        return sum(1 for n, _, _ in self.spans if n == STEP_SPAN)

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) / 1e6

    def _clipped(self, ops=None):
        lo, hi = self.window()
        ops = self.ops if ops is None else ops
        return [(max(s, lo), min(e, hi)) for _, s, e in ops if e > lo and s < hi]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return union_s(self._clipped())

    def busy_in_spans_s(self, span: str) -> float:
        """Device-busy seconds of the operations that started inside a host
        span named ``span`` (the benchmark synchronises at the end of each
        such span, so its device work lies inside it)."""
        return union_s(self._clipped(self._in_spans(span)))

    def _in_spans(self, span: str):
        ranges = [(s, e) for n, s, e in self.spans if n == span]
        return [op for op in self.ops if any(s <= op[1] < e for s, e in ranges)]

    def kind_s(self, span: str = "") -> Dict[str, float]:
        """Device seconds in the window by :func:`kernel_kind` (of the
        operations that started inside the spans named ``span``, if given)."""
        out: Dict[str, float] = {}
        lo, hi = self.window()
        for n, s, e in self._in_spans(span) if span else self.ops:
            if e > lo and s < hi:
                k = kernel_kind(n)
                out[k] = out.get(k, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time in the window, summed
        by name: ``[["<kind>: <name>", seconds], ...]``."""
        by: Dict[str, float] = {}
        lo, hi = self.window()
        for n, s, e in self.ops:
            if e > lo and s < hi:
                key = f"{kernel_kind(n)}: {n[:120]}"
                by[key] = by.get(key, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the window, summed by what the host
        was doing at each gap's start: the innermost benchmark span then
        open other than the step itself (``portbench.step`` where none
        is)."""
        lo, hi = self.window()
        busy = sorted(self._clipped())
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        cuts = sorted({t for _, s, e in self.spans for t in (s, e)})
        pieces = []
        for g0, g1 in gaps:  # each gap cut where a span opens or closes
            inner = [t for t in cuts if g0 < t < g1]
            pieces += list(zip([g0] + inner, inner + [g1]))
        by: Dict[str, float] = {}
        for g0, g1 in pieces:
            open_spans = [(s, n) for n, s, e in self.spans if s <= g0 < e]
            inner = [x for x in open_spans if x[1] != STEP_SPAN] or open_spans
            name = max(inner)[1] if inner else "outside the benchmark's spans"
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
