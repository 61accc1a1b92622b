"""The card's published peaks and the power limit it runs under.

Peaks are NVIDIA's data sheet for the H100 SXM part, dense rates: they
assume the full 700 W. A card set below that runs slower under load, so
every run reads its limit and prints it beside the shares of these peaks.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

#: float32 outside the tensor cores, FLOP/s.
FP32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts from ``nvidia-smi``, or None
    where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of its
    operations over the FLOP/s peak and its bytes over the HBM peak."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def roofline_share(trace: Optional[dict]) -> Optional[float]:
    """The least time for a profiled sub-window's work (``work_flops``,
    ``work_bytes``) over the summed device time of its kernels, %; None
    where the sub-window has no kernel time or no work counted."""
    if not trace or trace["kernel_s"] <= 0:
        return None
    flops, nbytes = trace.get("work_flops", 0.0), trace.get("work_bytes", 0)
    if not flops and not nbytes:
        return None
    return 100.0 * roofline_s(flops, nbytes) / trace["kernel_s"]


def idle_share(trace: Optional[dict]) -> Optional[float]:
    """The share of a profiled sub-window in which no operation (kernel,
    copy or fill) ran on the card, %; None where nothing ran."""
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
