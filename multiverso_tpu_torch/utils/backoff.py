"""One jittered exponential-backoff helper for every retry loop.

Before this module each retry site hand-rolled its own schedule —
``fetch_layout``'s inline doubling sleep, the sharded client's dial loop,
the multihost follower's fixed 0.1 s connect poll, the standby's fixed
0.2 s resubscribe poll. Hand-rolled loops drift: some forgot jitter (a
herd of clients orphaned by one restart retries in lockstep), some
forgot the cap, none could consult a retry budget. This helper is the
single schedule they all share:

* capped exponential delay: attempt ``k`` waits ``min(cap, base*2^(k-1))``
* full jitter (uniform in ``[delay/2, delay]``), matching
  :class:`multiverso_tpu_torch.fault.retry.RetryPolicy` so the whole stack
  desynchronizes the same way
* optional absolute deadline — ``wait()`` returns False instead of
  sleeping past it, so the caller's own failure path (raise, fatal,
  fail-all) stays in the caller
* optional cancel event — the sleep is interruptible, so a shutdown
  does not sit out a 2 s backoff
* optional retry-budget hook (:class:`multiverso_tpu_torch.fault.retry.
  RetryBudget` or anything with ``allow() -> bool``): a denied budget
  ends the retry sequence exactly like a deadline, so a degraded peer
  sees retry pressure decay instead of storm
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional


def full_jitter(base: float, cap: float, attempt: int,
                rng: Optional[random.Random] = None) -> float:
    """Jittered delay before attempt ``attempt`` (attempt 0 -> 0.0):
    uniform in [delay/2, delay] where delay = min(cap, base*2^(k-1))."""
    if attempt <= 0:
        return 0.0
    delay = min(float(cap), float(base) * (2.0 ** (attempt - 1)))
    r = rng if rng is not None else random
    return delay * (0.5 + 0.5 * r.random())


class Backoff:
    """One retry loop's backoff state. Usage::

        bo = Backoff(base=0.05, cap=1.0, deadline=time.monotonic() + 10)
        while True:
            try:
                return attempt_the_thing()
            except OSError:
                if not bo.wait():
                    raise  # deadline passed / budget denied / cancelled

    ``deadline`` is an ABSOLUTE ``time.monotonic()`` instant (None =
    retry forever); ``wait()`` refuses to start a sleep that would end
    past it. ``budget`` is consulted BEFORE each sleep — a denial ends
    the sequence without sleeping (the deny was already counted by the
    budget). ``cancel`` (a ``threading.Event``) interrupts the sleep and
    ends the sequence when set.
    """

    def __init__(self, base: float = 0.05, cap: float = 1.0,
                 deadline: Optional[float] = None,
                 budget: Optional[object] = None,
                 cancel: Optional[threading.Event] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.base = float(base)
        self.cap = float(cap)
        self.deadline = deadline
        self.budget = budget
        self.cancel = cancel
        self._rng = rng
        self.attempt = 0

    def remaining(self) -> float:
        """Seconds until the deadline (inf when none)."""
        if self.deadline is None:
            return float("inf")
        return self.deadline - time.monotonic()

    def wait(self) -> bool:
        """Sleep the next jittered delay. False = stop retrying (the
        deadline would pass mid-sleep, the retry budget denied, or the
        cancel event fired) — nothing was slept in the deadline/budget
        cases, so the caller's error path runs promptly."""
        self.attempt += 1
        if self.budget is not None and not self.budget.allow():
            return False
        delay = full_jitter(self.base, self.cap, self.attempt, self._rng)
        if self.deadline is not None:
            left = self.deadline - time.monotonic()
            if left <= delay:
                return False
        if self.cancel is not None:
            return not self.cancel.wait(delay)
        time.sleep(delay)
        return True
