"""Fault injection: a transport proxy that applies a seeded fault schedule.

The correctness tool that makes the rest of the fault subsystem verifiable:
:class:`ChaosNet` wraps :class:`~multiverso_tpu_torch.runtime.net.TcpNet` and
perturbs OUTBOUND frames per a rule list — drop / delay / duplicate /
reorder / one-way partition — predicated on (src, dst, MsgType, table) with
count/probability limiters. Rules are deterministic given ``fault_seed``,
so a chaos run replays exactly.

Spec DSL (the ``fault_spec`` flag; ';'-separated rules, first rule that
FIRES wins, non-firing matches still advance that rule's counter)::

    drop:type=Request_Add,every=3         # every 3rd Add frame vanishes
    dup:type=Reply_Add,first=2            # the first two Add replies send twice
    delay:type=Reply_Get,prob=0.5,seconds=0.2
    reorder:dst=0,after=4                 # hold a frame, release behind the next
    partition:src=1,dst=0                 # one-way: rank 1 can never reach rank 0
    corrupt:type=Request_Add,every=6      # seeded bit-flip in the blob payload
    stall:dst=0,seconds=0.2               # gray failure: drip one frame per 0.2s

Predicates: ``src= dst= table=`` (ints), ``type=`` (MsgType name or int).
Limiters: ``first=N`` (only the first N matches), ``after=N`` (skip the
first N), ``every=N`` (every Nth), ``prob=p`` (seeded coin, applied last).
``delay``/``reorder`` take ``seconds=`` (delay duration / hold fallback).
``stall`` is the slow-but-alive gray failure the breaker/deadline drills
need: matching frames enter a per-connection drip queue that releases ONE
frame every ``seconds=`` — head-of-line blocking included, unlike
``delay`` whose timers run concurrently. The peer stays connected and
correct, just pathologically slow.

Any existing test or bench runs under chaos by setting the flags — the
remote client/server build their transports through :func:`make_net`.
Injected events surface as ``FAULT_INJECTED_<ACTION>`` dashboard counters.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.net import _HEADER, TcpNet

_ACTIONS = ("drop", "delay", "dup", "reorder", "partition", "corrupt",
            "stall")


@dataclass
class FaultRule:
    """One schedule entry: predicates select frames, limiters select which
    of the matching frames actually suffer the action."""

    action: str
    src: Optional[int] = None
    dst: Optional[int] = None
    type: Optional[MsgType] = None
    table: Optional[int] = None
    first: Optional[int] = None
    after: int = 0
    every: Optional[int] = None
    prob: Optional[float] = None
    seconds: float = 0.05
    seen: int = field(default=0, repr=False)  # matching frames so far

    def matches(self, msg: Message) -> bool:
        if self.src is not None and msg.src != self.src:
            return False
        if self.dst is not None and msg.dst != self.dst:
            return False
        if self.type is not None and msg.type != self.type:
            return False
        if self.table is not None and msg.table_id != self.table:
            return False
        return True

    def applies(self, rng: random.Random) -> bool:
        """Limiter check for the CURRENT match (``seen`` already bumped)."""
        nth = self.seen - self.after
        if nth <= 0:
            return False
        if self.first is not None and nth > self.first:
            return False
        if self.every is not None and nth % self.every != 0:
            return False
        if self.prob is not None and rng.random() >= self.prob:
            return False
        return True


def parse_fault_spec(spec: str) -> List[FaultRule]:
    """Parse the ``fault_spec`` DSL into rules; malformed specs are fatal
    (a silently-ignored chaos schedule would fake a passing chaos run)."""
    rules: List[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        action, _, argstr = part.partition(":")
        action = action.strip()
        if action not in _ACTIONS:
            log.fatal("fault_spec: unknown action %r (want one of %s)",
                      action, "|".join(_ACTIONS))
        rule = FaultRule(action=action)
        for kv in filter(None, (s.strip() for s in argstr.split(","))):
            key, _, raw = kv.partition("=")
            key = key.strip()
            raw = raw.strip()
            if key in ("src", "dst", "table", "first", "after", "every"):
                setattr(rule, key, int(raw))
            elif key == "type":
                rule.type = (MsgType(int(raw)) if raw.lstrip("-").isdigit()
                             else MsgType[raw])
            elif key == "prob":
                rule.prob = float(raw)
            elif key == "seconds":
                rule.seconds = float(raw)
            else:
                log.fatal("fault_spec: unknown key %r in rule %r", key, part)
        rules.append(rule)
    return rules


class FaultInjector:
    """Evaluates the rule list against each outbound frame; the first rule
    that fires decides the frame's fate. Seeded, so probabilistic rules
    replay bit-for-bit across runs."""

    def __init__(self, rules: List[FaultRule], seed: int = 0) -> None:
        self.rules = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def fire(self, msg: Message) -> Optional[FaultRule]:
        with self._lock:
            for rule in self.rules:
                if not rule.matches(msg):
                    continue
                rule.seen += 1
                if rule.applies(self._rng):
                    count(f"FAULT_INJECTED_{rule.action.upper()}")
                    return rule
        return None

    def draw(self, n: int) -> int:
        """Seeded integer in [0, n) — corruption offsets/bit picks come
        from the same rng as the prob= coins, so a corrupt schedule
        replays bit-for-bit."""
        with self._lock:
            return self._rng.randrange(n)


class _Held:
    """A reorder-held frame: released behind the next frame to the same
    destination, or by a timer fallback — whichever comes first."""

    __slots__ = ("send", "released", "lock")

    def __init__(self, send) -> None:
        self.send = send
        self.released = False
        self.lock = threading.Lock()

    def release(self) -> None:
        with self.lock:
            if self.released:
                return
            self.released = True
        try:
            self.send()
        except OSError as exc:
            log.debug("chaos: held frame lost with its connection: %r", exc)


class ChaosNet(TcpNet):
    """TcpNet with the fault schedule applied to every outbound frame —
    both the dialed-send path (``_send``) and the explicit-connection reply
    path (``send_via``), so client requests and server replies are equally
    at risk. Inbound frames are untouched: every network fault is
    observable as a send-side event on one of the two endpoints."""

    def __init__(self, injector: FaultInjector) -> None:
        super().__init__()
        self._injector = injector
        self._held: Dict[object, List[_Held]] = {}
        self._held_lock = threading.Lock()
        # stall drip queues: key -> FIFO of deferred sends; one timer
        # chain per key releases one frame per rule.seconds
        self._stalled: Dict[object, List] = {}
        self._stall_lock = threading.Lock()

    # -- intercepted send paths ---------------------------------------------
    def _send(self, msg: Message, channel: int) -> int:
        sup = super(ChaosNet, self)
        return self._apply(msg, lambda: sup._send(msg, channel),
                           key=("rank", msg.dst),
                           raw=lambda fr: sup._send_raw(msg.dst, fr),
                           channel=channel)

    def send_via(self, conn, msg: Message, channel: int = 0,
                 flush: bool = False) -> int:
        sup = super(ChaosNet, self)
        return self._apply(msg,
                           lambda: sup.send_via(conn, msg, channel, flush),
                           key=("conn", id(conn)),
                           raw=lambda fr: sup._send_via_raw(conn, fr),
                           channel=channel)

    # -- schedule application -----------------------------------------------
    def _apply(self, msg: Message, send, key, raw, channel) -> int:
        self._release_held(key)
        rule = self._injector.fire(msg)
        if rule is None:
            return send()
        if rule.action in ("drop", "partition"):
            log.debug("chaos: %s frame %s->%s %s", rule.action, msg.src,
                      msg.dst, msg.type)
            return 0
        if rule.action == "corrupt":
            # seeded single-bit flip in the frame's blob section; the v3
            # frame CRC detects it receiver-side and the frame is
            # discarded — recovered by retransmit, exactly like a drop.
            # (Blob-less frames — heartbeats — pass through untouched:
            # header corruption would kill the connection, a different
            # failure class already covered by the reconnect path.)
            frame = bytearray(self._frame(msg, channel))
            if len(frame) <= _HEADER.size:
                return send()
            pos = _HEADER.size + self._injector.draw(
                len(frame) - _HEADER.size)
            frame[pos] ^= 1 << self._injector.draw(8)
            log.debug("chaos: corrupt frame %s->%s %s (byte %d)", msg.src,
                      msg.dst, msg.type, pos)
            return raw(bytes(frame))
        if rule.action == "dup":
            n = send()
            send()
            return n
        if rule.action == "delay":
            self._later(rule.seconds, send)
            return 0
        if rule.action == "stall":
            # gray failure: the peer is alive but drips — matching frames
            # queue per-connection and release ONE per rule.seconds, so
            # later stalled frames wait behind earlier ones (head-of-line
            # blocking, the signature a breaker must distinguish from a
            # dead peer)
            log.debug("chaos: stall frame %s->%s %s (%.3fs drip)",
                      msg.src, msg.dst, msg.type, rule.seconds)
            self._stall(key, send, rule.seconds)
            return 0
        # reorder: hold; the next frame to this destination overtakes it
        held = _Held(send)
        with self._held_lock:
            self._held.setdefault(key, []).append(held)
        self._later(rule.seconds, held.release)
        return 0

    def _stall(self, key, send, seconds: float) -> None:
        with self._stall_lock:
            q = self._stalled.setdefault(key, [])
            q.append(send)
            if len(q) > 1:
                return  # a drip chain for this key is already running
        self._later(seconds, lambda: self._drip(key, seconds))

    def _drip(self, key, seconds: float) -> None:
        with self._stall_lock:
            q = self._stalled.get(key)
            if not q:
                return
            send = q.pop(0)
            more = bool(q)
        try:
            send()
        except OSError as exc:
            log.debug("chaos: stalled frame lost with its connection: %r",
                      exc)
        if more:
            self._later(seconds, lambda: self._drip(key, seconds))

    def _release_held(self, key) -> None:
        with self._held_lock:
            backlog = self._held.pop(key, None)
        if backlog:
            # the caller's frame goes out first (it is about to be sent by
            # _apply's fall-through); emit the held ones right behind it
            # from the timer thread so the overtake is real
            self._later(0.0, lambda: [h.release() for h in backlog])

    @staticmethod
    def _later(seconds: float, fn) -> None:
        def run():
            try:
                fn()
            except OSError as exc:
                log.debug("chaos: deferred frame lost: %r", exc)
        timer = threading.Timer(max(seconds, 0.0), run)
        timer.daemon = True
        timer.start()


def corrupt_table_row(table, row: int) -> bool:
    """Flip one byte of ``row``'s APPLIED state in a server table — the
    seeded-divergence half of the audit chaos drills (MV_AUDIT_CORRUPT,
    shard/_child.py). Wire-level ``corrupt`` rules cannot stage this:
    the frame CRC discards a corrupted record before it applies, so it
    degrades to a drop. Real divergence — a bad host, a buggy updater, a
    torn restore — lives in applied state, which is what the fleet
    auditor's digests compare. Call under the owning dispatcher seam
    (``run_serialized`` / ``WarmStandby._run``); returns False when the
    row cannot be located. A dense table's tensor (``data``: array,
    matrix) is flipped in place on its device; the JAX package's version
    finds no row there."""
    import numpy as np
    import torch
    server = getattr(table, "_server_table", table)
    action = "state_corrupt"
    row = int(row)

    def flip(arr: np.ndarray) -> bool:
        view = arr.view(np.uint8).reshape(-1)
        if view.size == 0:
            return False
        view[0] ^= 0x01
        count(f"FAULT_INJECTED_{action.upper()}")
        log.error("chaos: corrupted applied state of table %s row %d "
                  "(drill)", getattr(server, "table_id", "?"), row)
        return True

    z = getattr(server, "_z", None)
    if isinstance(z, dict) and isinstance(z.get(row), np.ndarray):
        return flip(z[row])
    tier = getattr(server, "_tier", None)
    if tier is not None:
        cold = tier.get(row)
        if cold is None:
            return False
        arr = np.array(cold, copy=True)
        ok = flip(arr)
        if ok:
            tier.put(row, arr)
        return ok
    store = getattr(server, "_store", None)
    if isinstance(store, dict):
        value = store.get(row)
        if isinstance(value, np.ndarray):
            return flip(value)
        if value is not None:
            store[row] = (value ^ 1 if isinstance(value, int)
                          else repr(value) + "\x00")
            count(f"FAULT_INJECTED_{action.upper()}")
            return True
        return False
    if isinstance(store, np.ndarray):
        target = store[row] if store.ndim > 1 and row < len(store) else store
        return flip(np.atleast_1d(target))
    data = getattr(server, "data", None)
    if isinstance(data, torch.Tensor) and 0 <= row < data.shape[0]:
        # the dense tables' tensor state (array, matrix), on its device:
        # flip the low bit of the row's first byte in place
        target = data[row] if data.dim() > 1 else data[row:row + 1]
        target.view(torch.uint8).view(-1)[:1].bitwise_xor_(1)
        count(f"FAULT_INJECTED_{action.upper()}")
        log.error("chaos: corrupted applied state of table %s row %d "
                  "(drill)", getattr(server, "table_id", "?"), row)
        return True
    return False


def make_net() -> TcpNet:
    """Transport factory keyed on the chaos flags: plain TcpNet normally, a
    ChaosNet under ``fault_spec`` — the seam that lets any test or bench
    run under a seeded fault schedule without code changes."""
    spec = str(config.get_flag("fault_spec"))
    if not spec.strip():
        return TcpNet()
    injector = FaultInjector(parse_fault_spec(spec),
                             seed=int(config.get_flag("fault_seed")))
    log.info("fault injection active: %d rule(s), seed=%d",
             len(injector.rules), config.get_flag("fault_seed"))
    return ChaosNet(injector)
