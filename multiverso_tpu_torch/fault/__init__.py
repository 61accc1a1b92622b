"""Fault subsystem (port of ``multiverso_tpu/fault/``, in part).

* :mod:`~multiverso_tpu_torch.fault.inject` — a seeded, rule-based
  transport proxy (drop/delay/dup/reorder/partition/corrupt/stall)
  switched on by the ``fault_spec``/``fault_seed`` flags, so any run can
  go under chaos.
* :mod:`~multiverso_tpu_torch.fault.retry` — backoff with jitter and
  deadlines for remote clients, the retry budget and the circuit
  breaker; paired with idempotent request ids and the server's dedup
  window, a retried Add applies exactly once.
* :mod:`~multiverso_tpu_torch.fault.detector` — heartbeat/lease
  tracking; the sync watchdog evicts a worker whose lease expired, so
  BSP/SSP rounds do not deadlock on a crashed peer.

Counters (``CLIENT_RETRIES``, ``CLIENT_RECONNECTS``,
``SERVER_DEDUP_HITS``, ``WORKER_EVICTIONS``, ``FAULT_INJECTED_*``)
register in the dashboard. The lock-order sanitizer (``lockcheck``)
waits for its slice (``ROADMAP.md``).
"""

from multiverso_tpu_torch.fault.detector import LivenessDetector  # noqa: F401
from multiverso_tpu_torch.fault.inject import (  # noqa: F401
    ChaosNet, FaultInjector, FaultRule, make_net, parse_fault_spec)
from multiverso_tpu_torch.fault.retry import (  # noqa: F401
    CircuitBreaker, RetryBudget, RetryPolicy)
