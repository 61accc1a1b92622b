"""The autopilot's safety interlock: integrity beats optimization (port
of ``multiverso_tpu/autopilot/interlock.py``).

A controller that reshapes a fleet whose replicas disagree about state
is a controller amplifying corruption — so the interlock latches the
autopilot FROZEN the moment the integrity plane reports divergence, and
nothing but an explicit operator acknowledgement unfreezes it:

* every :meth:`check` consults the queryable auditor state
  (``FleetAuditor.divergent``) AND the process-local
  ``AUDIT_DIVERGENCE`` counter (so an auditor running in this process
  but not handed to the interlock still trips it);
* the freeze is LATCHING: the auditor's flag auto-clears on a clean
  sweep, but a fleet that diverged and "recovered" unsupervised still
  needs a human to decide the surviving state is the right one;
* :meth:`ack` is the only unfreeze. It re-baselines the divergence
  counter and clears the latch — and if divergence persists, the very
  next check freezes again (an ack is consent to resume, not a mute).

Freeze/unfreeze transitions count ``AUTOPILOT_FREEZES`` /
``AUTOPILOT_ACKS``, hold the ``AUTOPILOT_FROZEN`` gauge (the operator's
dashboard bit), and drop ``autopilot_frozen`` / ``autopilot_ack``
flight-recorder dumps carrying the trigger and the auditor's report —
the runbook in docs/autopilot.md starts from that dump.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import Dashboard, count, gauge_set
from multiverso_tpu_torch.obs.trace import flight_dump


class SafetyInterlock:
    """Latching divergence interlock between policy and actuators."""

    def __init__(self, auditor: Any = None) -> None:
        self.auditor = auditor
        self.frozen = False
        self.frozen_since: Optional[float] = None
        self.freeze_reason: str = ""
        # divergences seen before the autopilot existed are the
        # operator's business, not grounds to refuse to start
        self._baseline = Dashboard.counter_value("AUDIT_DIVERGENCE")

    def check(self) -> bool:
        """May the autopilot act this tick? False while frozen; freezes
        (and returns False) when the integrity plane reports divergence."""
        if self.frozen:
            return False
        seen = Dashboard.counter_value("AUDIT_DIVERGENCE")
        if seen > self._baseline:
            self.freeze(f"AUDIT_DIVERGENCE counter advanced "
                        f"({self._baseline} -> {seen})")
            return False
        if self.auditor is not None and \
                getattr(self.auditor, "divergent", False):
            self.freeze("fleet auditor reports live divergence")
            return False
        return True

    def freeze(self, reason: str) -> None:
        """Latch the autopilot frozen (idempotent)."""
        if self.frozen:
            return
        self.frozen = True
        self.frozen_since = time.time()
        self.freeze_reason = str(reason)
        count("AUTOPILOT_FREEZES")
        gauge_set("AUTOPILOT_FROZEN", 1)
        status = (self.auditor.status()
                  if self.auditor is not None
                  and hasattr(self.auditor, "status") else None)
        # "reason" is the dump's event name — the trigger text rides as
        # "why" so the renderer can't clobber it
        flight_dump("autopilot_frozen", why=self.freeze_reason,
                    audit_status=status)
        log.error("autopilot: FROZEN — %s (unfreeze requires an "
                  "operator ack; docs/autopilot.md runbook)", reason)

    def ack(self, operator: str = "operator") -> None:
        """The explicit operator acknowledgement — the ONLY unfreeze.
        Re-baselines the divergence counter; if divergence persists the
        next check() freezes again immediately."""
        self._baseline = Dashboard.counter_value("AUDIT_DIVERGENCE")
        was = self.frozen
        self.frozen = False
        self.frozen_since = None
        reason, self.freeze_reason = self.freeze_reason, ""
        if was:
            count("AUTOPILOT_ACKS")
            gauge_set("AUTOPILOT_FROZEN", 0)
            flight_dump("autopilot_ack", operator=str(operator),
                        cleared=reason)
            log.info("autopilot: unfrozen by %s (was: %s)", operator,
                     reason)

    def status(self) -> Dict[str, Any]:
        return {"frozen": self.frozen,
                "frozen_since": self.frozen_since,
                "reason": self.freeze_reason,
                "divergence_baseline": self._baseline}
