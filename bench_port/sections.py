"""An idle gap of the device named by the port's own timed sections
(``dashboard.monitor`` in ``multiverso_tpu_torch``), where they are on the
profile's clock: with ``Dashboard.profile_annotations`` on, each section is
a ``torch.profiler`` range on the thread that ran it.

``devtrace`` does not call it yet. Wired in, ``devtrace.profiled`` would
turn ``profile_annotations`` on for its sub-window while the port is
loaded, and ``devtrace._label`` would pass its ``bench.*`` label through
:func:`label` with :func:`program_spans` of the events it already reads.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

#: The port's sections that only wait for a reply or for the device: a gap
#: names them only when no working section covers it.
WAITING = re.compile(r"^(WORKER_TABLE_SYNC_.*|W2V_FINISH_WAIT|W2V_BLOCK_SYNC)$")
#: The port's section names (the Dashboard's convention), apart from the
#: profiler's own ranges (``aten::...``, ``cuda...``) and the benchmark's.
SECTION = re.compile(r"^[A-Z][A-Z0-9_]*$")

#: A section on the profile's clock: (start, end, name, thread).
Span = Tuple[float, float, str, int]


def label(gap: Tuple[float, float], program: List[Span], base: str) -> str:
    """``base`` (the benchmark's label of the gap, kept as it is) and, after
    ``|``, the port's sections that cover the gap: the leaf sections on
    their threads (no other section of the thread nested in them over the
    gap), those covering at least half as much of it as the largest,
    joined by ``+``. Sections that only wait (:data:`WAITING`) are named
    only where no working section covers the gap."""
    over = [r for r in program if min(r[1], gap[1]) > max(r[0], gap[0])]

    def leaf(r) -> bool:
        return not any(o is not r and o[3] == r[3] and r[0] <= o[0]
                       and o[1] <= r[1] for o in over)

    leaves = [r for r in over if leaf(r)]
    for group in ([r for r in leaves if not WAITING.match(r[2])],
                  [r for r in leaves if WAITING.match(r[2])]):
        cover: Dict[str, float] = defaultdict(float)
        for s, e, name, _ in group:
            cover[name] += min(e, gap[1]) - max(s, gap[0])
        if cover:
            top = max(cover.values())
            return base + "|" + "+".join(sorted(
                n for n, v in cover.items() if v >= 0.5 * top))
    return base


def program_spans(events) -> List[Span]:
    """The port's sections among a profile's host-side events."""
    import torch
    return [(e.time_range.start, e.time_range.end, e.name, e.thread)
            for e in events if SECTION.match(e.name)
            and e.device_type != torch.autograd.DeviceType.CUDA]
