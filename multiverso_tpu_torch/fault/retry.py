"""Retry policy: exponential backoff with full jitter under a deadline.

The parameter-server literature (Li et al., OSDI'14) makes fault tolerance
hinge on *replayable, idempotent* messages: a sender may retry freely
because the receiver deduplicates. This module is the sender half — the
backoff schedule remote clients use for reconnect-and-resume and for
per-request retransmission (:mod:`multiverso_tpu_torch.runtime.remote`). The
receiver half is the server's req-id dedup window; liveness is
:mod:`multiverso_tpu_torch.fault.detector`.

Jitter is *full* jitter (uniform in [delay/2, delay]) so a herd of clients
orphaned by one server restart does not reconnect in lockstep. The jitter
math itself lives in :mod:`multiverso_tpu_torch.utils.backoff` — one schedule
shared by every retry loop in the stack.

Free retries are only safe while the receiver is healthy. Under sustained
overload they invert: each timed-out request becomes two, and the retry
plane amplifies exactly the load that caused the timeouts. Two governors
bound that amplification:

* :class:`RetryBudget` — a token bucket refilled by *successes*. Every
  retransmit, read hedge, or layout re-fetch spends a token; when the
  success rate collapses the bucket drains and retry pressure decays to
  the refill ratio instead of storming.
* :class:`CircuitBreaker` — consecutive-failure trip wire. Open = stop
  sending: writes fail fast with a truthful error, reads fall back to
  replicas. After ``reset_seconds`` one half-open probe is let through;
  its outcome closes or re-opens the breaker.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Iterator, Optional, Tuple

from multiverso_tpu_torch.dashboard import count, gauge_set
from multiverso_tpu_torch.utils.backoff import full_jitter


class RetryPolicy:
    """Backoff schedule: attempt k (k>=1) sleeps ``min(cap, base*2^(k-1))``
    jittered, attempt 0 runs immediately; the whole sequence stops when
    ``deadline`` seconds have elapsed. ``deadline=0`` yields NO attempts —
    the fail-fast escape hatch."""

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 deadline: float = 30.0,
                 rng: Optional[random.Random] = None) -> None:
        self.base = float(base)
        self.cap = float(cap)
        self.deadline = float(deadline)
        self._rng = rng if rng is not None else random.Random()

    @classmethod
    def from_flags(cls, deadline: Optional[float] = None) -> "RetryPolicy":
        from multiverso_tpu_torch import config
        if deadline is None:
            deadline = float(config.get_flag("reconnect_deadline_seconds"))
        return cls(base=float(config.get_flag("retry_base_seconds")),
                   cap=float(config.get_flag("retry_cap_seconds")),
                   deadline=deadline)

    def backoff(self, attempt: int) -> float:
        """Jittered sleep before attempt ``attempt`` (0 -> no sleep)."""
        return full_jitter(self.base, self.cap, attempt, self._rng)

    def attempts(self) -> Iterator[Tuple[int, float]]:
        """Yield ``(attempt_index, seconds_remaining)`` pairs, sleeping the
        jittered backoff between yields; stops once the deadline passes.
        Callers break out on success."""
        start = time.monotonic()
        attempt = 0
        while True:
            remaining = self.deadline - (time.monotonic() - start)
            if remaining <= 0:
                return
            yield attempt, remaining
            attempt += 1
            delay = self.backoff(attempt)
            remaining = self.deadline - (time.monotonic() - start)
            if remaining <= 0:
                return
            time.sleep(min(delay, remaining))


class RetryBudget:
    """Success-refilled token bucket governing retries on one connection.

    Every first-send is free (it is not a retry); every *extra* send —
    retransmit, read hedge, layout re-fetch — must :meth:`allow` first.
    Successes refill ``ratio`` tokens each, so the steady-state retry rate
    is bounded at ``ratio`` x the success rate: a healthy peer affords
    hedging, a degraded peer sees retry pressure decay instead of doubling
    its queue. Denials are counted (``RETRY_BUDGET_DENIALS``) and the
    caller DEFERS or skips the retry — a denial never fails a request,
    the original flight stays pending.

    ``tokens <= 0`` disables the budget (every retry allowed) — the
    compatibility default; drills and overload-sensitive deployments turn
    it on via the ``retry_budget_tokens`` flag. Thread-safe: client pump,
    maintenance timer, and read scheduler all spend from it.
    """

    def __init__(self, tokens: float = 0.0, ratio: float = 0.1) -> None:
        self.cap = float(tokens)
        self.ratio = float(ratio)
        self._tokens = self.cap
        self._lock = threading.Lock()

    @classmethod
    def from_flags(cls) -> "RetryBudget":
        from multiverso_tpu_torch import config
        return cls(tokens=float(config.get_flag("retry_budget_tokens")),
                   ratio=float(config.get_flag("retry_budget_ratio")))

    @property
    def enabled(self) -> bool:
        return self.cap > 0

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def on_success(self) -> None:
        """A correlated reply arrived: refill ``ratio`` tokens (capped)."""
        if not self.enabled:
            return
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)
            gauge_set("RETRY_BUDGET_TOKENS", self._tokens)

    def allow(self) -> bool:
        """Spend one token for a retry; False (and a counted denial) when
        the bucket is dry."""
        if not self.enabled:
            return True
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                gauge_set("RETRY_BUDGET_TOKENS", self._tokens)
                return True
        count("RETRY_BUDGET_DENIALS")
        return False


class CircuitBreaker:
    """Consecutive-failure breaker for one client->server connection.

    Closed: everything flows, any success resets the failure streak.
    ``failures`` consecutive failures (retransmit timeouts, recovery
    events) trip it open (``BREAKER_TRIPS``, gauge ``BREAKER_OPEN``=1):
    :meth:`allow` returns False so writes fail fast with a truthful
    "circuit open" error and the read tier stops falling back to the
    primary — replicas keep serving. After ``reset_seconds`` ONE
    half-open probe is admitted; its success closes the breaker, its
    failure re-opens the window.

    ``failures <= 0`` disables the breaker entirely (never opens) — the
    compatibility default, enabled via the ``breaker_failures`` flag.
    """

    _CLOSED, _OPEN, _HALF_OPEN = 0, 1, 2

    def __init__(self, failures: int = 0, reset_seconds: float = 5.0) -> None:
        self.threshold = int(failures)
        self.reset_seconds = float(reset_seconds)
        self._state = self._CLOSED
        self._streak = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    @classmethod
    def from_flags(cls) -> "CircuitBreaker":
        from multiverso_tpu_torch import config
        return cls(failures=int(config.get_flag("breaker_failures")),
                   reset_seconds=float(config.get_flag("breaker_reset_seconds")))

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    @property
    def is_open(self) -> bool:
        """True while the breaker refuses normal traffic (the half-open
        probe window still reports open — callers that just need a yes/no
        should use :meth:`allow`)."""
        with self._lock:
            return self._state != self._CLOSED

    def record_success(self) -> None:
        with self._lock:
            self._streak = 0
            if self._state != self._CLOSED:
                self._state = self._CLOSED
                gauge_set("BREAKER_OPEN", 0.0)

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._streak += 1
            if self._state == self._HALF_OPEN:
                # the probe failed — restart the open window
                self._state = self._OPEN
                self._opened_at = time.monotonic()
                return
            if self._state == self._CLOSED and self._streak >= self.threshold:
                self._state = self._OPEN
                self._opened_at = time.monotonic()
                count("BREAKER_TRIPS")
                gauge_set("BREAKER_OPEN", 1.0)

    def allow(self) -> bool:
        """May a request be sent right now? Closed -> yes. Open -> no,
        until ``reset_seconds`` elapse, then exactly one half-open probe
        gets a yes (the caller MUST feed its outcome back via
        record_success/record_failure)."""
        if not self.enabled:
            return True
        with self._lock:
            if self._state == self._CLOSED:
                return True
            if self._state == self._OPEN and \
                    time.monotonic() - self._opened_at >= self.reset_seconds:
                self._state = self._HALF_OPEN
                return True
            return False
