"""The card's trace of a measured window, read into plain numbers.

`Trace` wraps `torch.profiler` (CUPTI) around the window. A trace loses
the first kernels launched in it, so it opens with `LEAD_IN` launches of
a fill kernel, which the readings leave out. What it gives the metrics:
the device intervals (kernels, copies, fills) with their names, the host
events the profiler saw, the traced window's length by the host clock,
and from those the device's busy time, the time of each kernel by name,
and the longest idle gaps with the host event running across each.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from portbench.stats import merged, union_length

LEAD_IN = 128
FILL = "portbench_lead_in"
# the harness's own host spans (`read:<kind>`) and the fill
LABELS = ("read:", FILL)


class Trace:
    def __init__(self, device: str = "cuda"):
        self.on_card = device == "cuda"
        self.prof = None
        self.window_s = 0.0
        self.device: List[Tuple[str, float, float]] = []  # (name, start s, end s)
        self.host: List[Tuple[str, float, float]] = []
        self._t0 = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
            lead = torch.empty(1, device="cuda")
            torch.cuda.synchronize()
        try:
            # the host events of every client thread, not only this one
            from torch._C._profiler import _ExperimentalConfig

            kw = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):
            kw = {}
        self.prof = profile(activities=acts, **kw)
        self.prof.__enter__()
        if self.on_card:
            with torch.profiler.record_function(FILL):
                for _ in range(LEAD_IN):
                    lead.zero_()
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        self._read()
        return False

    def _read(self):
        events = self.prof.profiler.kineto_results.events()
        fill_end = None
        dev, host = [], []
        for e in events:
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            name = e.name()
            # a `record_function` span is also drawn on the device's
            # timeline as an annotation; it is no device work
            if str(e.device_type()).endswith("CUDA") and not name.startswith(LABELS):
                dev.append((name, start, end))
            else:
                host.append((name, start, end))
                if name == FILL:
                    fill_end = end if fill_end is None else max(fill_end, end)
        dev.sort(key=lambda x: x[1])
        # the fill's own launches and anything before its host span ended
        # are lead-in, not window
        if fill_end is not None:
            dev = [d for d in dev if d[1] >= fill_end]
            host = [h for h in host if h[2] >= fill_end and h[0] != FILL]
        self.device = dev
        self.host = host

    # -- readings ------------------------------------------------------------

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device])

    def kernel_s(self, *names: str) -> Tuple[float, int]:
        """Total device time and count of the device events whose name
        holds any of `names`."""
        t, n = 0.0, 0
        for name, s, e in self.device:
            if any(x in name for x in names):
                t += e - s
                n += 1
        return t, n

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest gaps between device intervals, each named by the
        shortest host event that spans its middle (the innermost op the
        host was in), summed by that name."""
        spans = merged([(s, e) for _, s, e in self.device])
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        find = _Innermost(self.host)
        by: Dict[str, float] = {}
        for length, s, e in gaps[: 20 * n]:
            label = find(0.5 * (s + e)) or "no traced host event"
            by[label] = by.get(label, 0.0) + length
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class _Innermost:
    """The name of the shortest host event spanning a time."""

    def __init__(self, host: List[Tuple[str, float, float]]):
        import numpy as np

        self.names = [h[0][:120] for h in host]
        self.start = np.array([h[1] for h in host], dtype=np.float64)
        self.end = np.array([h[2] for h in host], dtype=np.float64)

    def __call__(self, t: float) -> Optional[str]:
        import numpy as np

        hit = np.flatnonzero((self.start <= t) & (self.end >= t))
        if hit.size == 0:
            return None
        return self.names[int(hit[np.argmin(self.end[hit] - self.start[hit])])]
