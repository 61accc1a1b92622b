"""A profiled sub-window: what the device did while the benchmark drove the
port for a few seconds, from ``torch.profiler`` (CUPTI on the card).

The union of the device's busy intervals, the kernels' summed time (copies
and fills apart), the device operations that took most time, and the
longest idle gaps labelled by the benchmark's own ``record_function``
ranges (``bench.*``) that the host was in when the device went idle.
Adapted from ``profile()`` of the repository's chip smoke script.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "bench.window"
TOP = 10


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def profiled(fn: Callable[[], None]) -> Dict:
    """Run ``fn`` under the profiler and summarise the device's work inside
    the ``bench.window`` range around it (seconds)."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kwargs = {}
    try:  # ranges opened on the worker threads and the dispatcher too
        from torch._C._profiler import _ExperimentalConfig
        kwargs["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, **kwargs) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    events = prof.events()
    win = [e for e in events if e.name == WINDOW
           and e.device_type != torch.autograd.DeviceType.CUDA]
    lo, hi = ((win[0].time_range.start, win[0].time_range.end) if win
              else (float("-inf"), float("inf")))
    device, ranges = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("bench."):
            # the benchmark's ranges; their copies on the device's
            # timeline (user annotations) are not device work
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    and e.name != WINDOW):
                ranges.append((start, end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            start, end = max(start, lo), min(end, hi)
            if end > start and not getattr(e, "is_user_annotation", False):
                device.append((start, end, e.name))
    busy = _union([(s, e) for s, e, _ in device])
    window_us = (hi - lo) if win else host_s * 1e6
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_name[name] += e - s
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": window_us / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernel_s": sum(e - s for s, e, n in device if not _is_copy(n)) / 1e6,
        "device_ops": [[name, us / 1e6] for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_label(g, ranges), (g[1] - g[0]) / 1e6] for g in gaps],
    }


def _label(gap: Tuple[float, float], ranges: List[Tuple[float, float, str]]
           ) -> str:
    """The benchmark's ranges that the host was in over most of a gap, or
    ``outside bench ranges``."""
    cover: Dict[str, float] = defaultdict(float)
    for s, e, name in ranges:
        overlap = min(e, gap[1]) - max(s, gap[0])
        if overlap > 0:
            cover[name] += overlap
    if not cover:
        return "outside bench ranges"
    return "+".join(sorted(n for n, v in cover.items()
                           if v >= 0.5 * max(cover.values())))
