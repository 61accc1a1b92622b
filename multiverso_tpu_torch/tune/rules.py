"""The tuner's rule table: dominant cost -> one bounded knob step (port
of ``multiverso_tpu/tune/rules.py``).

Each :class:`Rule` pairs a predicate over the fused
:class:`~multiverso_tpu_torch.tune.sensors.TuneSense` snapshot with an ordered
candidate list of :class:`KnobStep`\\ s — the first candidate that can
still move (not pinned at its bound) is the proposal. Steps are
geometric (double / halve) and hard-bounded, the same shape as the read
router's p95-derived hedge delay (PR 7) generalized: sense a pressure,
move ONE knob a bounded notch, let the verify phase judge it.

The mapping (docs/autotune.md has the full rationale):

=================  =====================================================
dominant cost      step
=================  =====================================================
``wal_fsync``      raise ``apply_batch_msgs`` — fewer, larger applies
                   amortize the durability barrier
``shm_ring_spin``  back off ``wire_shm_spin`` toward 0 — the poller is
                   burning the core the producer needs
wire segment /     raise ``wire_coalesce_frames``, then
``net_recv``       ``wire_coalesce_bytes``, then descend the
                   ``wire_quant_bits`` ladder (8→4→2→1 — lossy, last
                   resort, Seide et al.'s tradeoff)
``tier_cold_fetch``lower ``tier_admit_touches`` toward 1 — the
                   admission bar is refusing promotions the workload
                   re-reads
hedge losses       raise ``read_hedge_ms`` off the effective delay —
                   hedges that fire and lose are pure wasted wire
cache misses       raise ``client_cache_bytes`` — the working set
                   outgrew the cache
=================  =====================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from multiverso_tpu_torch.tune.sensors import TuneSense

# a wait site must burn at least this much of the window before the
# tuner calls it dominant — idle-process noise must not move knobs
MIN_WAIT_SECONDS = 0.05
# pressure floors for the rate-based rules (events/second)
MIN_HEDGE_RATE = 1.0
MIN_MISS_RATE = 1.0

# wait sites a rule can actually act on. Dominance is judged among
# THESE, not all sites: dispatcher_drain and net_recv-style parks are
# mostly idleness, and an idle site outweighing every real cost would
# otherwise mask the one signal the tuner can do something about.
ACTIONABLE_SITES = ("wal_fsync", "shm_ring_spin", "net_recv",
                    "tier_cold_fetch")


def actionable_dominant(sense: TuneSense) -> Tuple[str, float]:
    """(site, windowed seconds) of the heaviest actionable wait site,
    or ("", 0.0) when none clears MIN_WAIT_SECONDS."""
    best, best_s = "", 0.0
    for site in ACTIONABLE_SITES:
        s = sense.wait.get(site, 0.0)
        if s > best_s:
            best, best_s = site, s
    if best_s < MIN_WAIT_SECONDS:
        return "", 0.0
    return best, best_s


@dataclass
class KnobStep:
    """One bounded move of one flag. ``propose`` returns the new value,
    or None when the knob is pinned (at its bound, or has no seed)."""

    flag: str
    kind: str = "up"            # up | down | ladder
    lo: float = 0.0
    hi: float = float(1 << 30)
    factor: float = 2.0
    seed: float = 0.0           # used when current == 0 and kind == up
    ladder: Tuple[float, ...] = ()
    seed_from: Optional[Callable[[TuneSense], float]] = None

    def propose(self, current: float,
                sense: TuneSense) -> Optional[float]:
        current = float(current)
        if self.kind == "ladder":
            steps = list(self.ladder)
            if current in steps:
                idx = steps.index(current)
                if idx + 1 >= len(steps):
                    return None
                return steps[idx + 1]
            return steps[0] if steps else None
        if self.kind == "up":
            if current <= 0:
                seed = (self.seed_from(sense) if self.seed_from
                        else self.seed)
                if seed <= 0:
                    return None
                return min(float(self.hi), float(seed))
            new = min(float(self.hi), current * self.factor)
            return new if new > current else None
        if self.kind == "down":
            new = max(float(self.lo), current / self.factor)
            return new if new < current else None
        raise ValueError(f"KnobStep: unknown kind {self.kind!r}")


@dataclass
class Rule:
    """Predicate + ordered knob candidates. ``predicate`` returns the
    human-readable reason when the rule matches, None otherwise."""

    name: str
    predicate: Callable[[TuneSense], Optional[str]]
    steps: List[KnobStep] = field(default_factory=list)


def _wait_dominant(site: str) -> Callable[[TuneSense], Optional[str]]:
    def pred(s: TuneSense) -> Optional[str]:
        dom, secs = actionable_dominant(s)
        if dom == site:
            return (f"{site} dominates actionable waits "
                    f"({secs:.3f}s/window)")
        return None
    return pred


def _wire_dominant(s: TuneSense) -> Optional[str]:
    if s.dominant_segment.startswith("wire:"):
        return f"critical path dominated by {s.dominant_segment}"
    dom, secs = actionable_dominant(s)
    if dom == "net_recv":
        return (f"net_recv dominates actionable waits "
                f"({secs:.3f}s/window)")
    return None


def _hedge_losing(s: TuneSense) -> Optional[str]:
    if (s.hedge_rate >= MIN_HEDGE_RATE
            and s.hedge_win_rate < 0.5 * s.hedge_rate):
        return (f"hedges firing at {s.hedge_rate:.1f}/s but winning "
                f"only {s.hedge_win_rate:.1f}/s — delay too eager")
    return None


def _cache_thrashing(s: TuneSense) -> Optional[str]:
    if (s.cache_miss_rate >= MIN_MISS_RATE
            and s.cache_miss_rate > s.cache_hit_rate):
        return (f"read cache missing at {s.cache_miss_rate:.1f}/s vs "
                f"{s.cache_hit_rate:.1f}/s hits — working set outgrew it")
    return None


def _hedge_seed(s: TuneSense) -> float:
    # seed off the EFFECTIVE delay the router runs (p95-derived when the
    # flag is 0): pin it at double, minimum 1 ms
    return max(1.0, s.hedge_delay_seconds * 1000.0 * 2.0)


def default_rules() -> List[Rule]:
    """The built-in table, priority-ordered (first match proposes)."""
    return [
        Rule("wal_fsync",
             _wait_dominant("wal_fsync"),
             [KnobStep("apply_batch_msgs", "up", lo=0, hi=1024, seed=8)]),
        Rule("shm_ring_spin",
             _wait_dominant("shm_ring_spin"),
             [KnobStep("wire_shm_spin", "down", lo=0)]),
        Rule("wire",
             _wire_dominant,
             [KnobStep("wire_coalesce_frames", "up", lo=0, hi=512,
                       seed=8),
              KnobStep("wire_coalesce_bytes", "up", lo=0, hi=8 << 20,
                       seed=1 << 16),
              KnobStep("wire_quant_bits", "ladder",
                       ladder=(0, 8, 4, 2, 1))]),
        Rule("tier_cold_fetch",
             _wait_dominant("tier_cold_fetch"),
             [KnobStep("tier_admit_touches", "down", lo=1)]),
        Rule("hedge",
             _hedge_losing,
             [KnobStep("read_hedge_ms", "up", lo=0, hi=1000,
                       seed_from=_hedge_seed)]),
        Rule("cache",
             _cache_thrashing,
             [KnobStep("client_cache_bytes", "up", lo=0, hi=256 << 20,
                       seed=1 << 20)]),
    ]
