"""The port's ``RangeTailer`` (``multiverso_tpu_torch/durable/migrate.py``)
without a live donor — the three cases of ``tests/test_migrate_unit.py``:
the tailer is built standalone (``zoo.server=None`` runs its dispatcher
seam inline) with a recording transport, and the replication stream is
injected as crafted ``Control_Wal_Record`` / ``Control_Reply_Migrate``
frames. Each scenario is also played through the JAX package's tailer:
the absorbed ranges, the applied Adds, the subscribes and the watermarks
must be the same."""

from types import SimpleNamespace

import numpy as np
import pytest

from multiverso_tpu.durable import migrate as jmigrate
from multiverso_tpu.runtime import message as jmessage
from multiverso_tpu.runtime import wire as jwire

from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.durable import migrate
from multiverso_tpu_torch.runtime import message, wire

PORT = (migrate, message, wire)
JAX = (jmigrate, jmessage, jwire)


@pytest.fixture(autouse=True)
def port_dashboard():
    """The port's counters from zero (tests/conftest.py resets the JAX
    side's)."""
    Dashboard.reset()
    yield


class _FakeNet:
    def __init__(self, msg_type):
        self.sent = []
        self._type = msg_type

    def send(self, msg):
        self.sent.append(msg)

    def subscribes(self):
        return [m for m in self.sent if m.type == self._type]


class _FakeTable:
    def __init__(self):
        self.absorbed = []
        self.adds = []

    def absorb_range(self, start, values):
        self.absorbed.append((start, np.asarray(values).copy()))

    def process_add(self, request):
        self.adds.append(request)


class _Scenario:
    """One tailer of one package fed crafted frames."""

    def __init__(self, pkg):
        self.mod, self.msg, self.wire = pkg
        self.table = _FakeTable()
        spec = {"table_id": 0, "server_table": self.table, "kind": "matrix",
                "donor_lo": 4, "donor_hi": 8, "rcpt_start": 0,
                "rcpt_size": 0, "num_col": 2}
        self.tailer = self.mod.RangeTailer(
            "fake:0", [spec], zoo=SimpleNamespace(server=None),
            lease_seconds=30.0)
        self.tailer._net = _FakeNet(self.msg.MsgType.Control_Migrate)

    def record(self, seq, row=5):
        request = (np.array([row], np.int32),
                   np.full((1, 2), float(seq), np.float32), None)
        self.tailer._on_record(self.msg.Message(
            src=0, dst=-1, type=self.msg.MsgType.Control_Wal_Record,
            table_id=0, msg_id=seq, watermark=seq,
            data=self.wire.encode(request)))

    def transfer(self, watermark):
        # the pump's Control_Reply_Migrate handling: the flag clears
        # BEFORE the transfer loads, then the raced backlog replays
        self.tailer._awaiting_transfer = False
        self.tailer._load_transfer({"tables": {0: np.zeros((4, 2), np.float32)},
                                    "watermark": watermark})

    def trace(self):
        t = self.tailer
        return {"absorbed": [(s, v.tolist()) for s, v in self.table.absorbed],
                "adds": [(np.asarray(r[0]).tolist(), np.asarray(r[1]).tolist())
                         for r in self.table.adds],
                "subscribes": [self.wire.decode(m.data)
                               for m in t._net.subscribes()],
                "applied": t.applied_watermark,
                "received": t.received_watermark,
                "records_applied": t.records_applied,
                "awaiting": t._awaiting_transfer,
                "buffered": len(t._pretransfer)}


def _both(play):
    """Play ``play(scenario)`` on the port and on the JAX package; the
    traces must agree. Returns the port's scenario."""
    port, jax_ = _Scenario(PORT), _Scenario(JAX)
    play(port)
    play(jax_)
    assert port.trace() == jax_.trace()
    return port


def test_gap_detect_resubscribes_and_fresh_transfer_resyncs():
    def play(s):
        s.tailer._awaiting_transfer = True
        s.transfer(5)
        s.record(6)
        s.record(8)      # record 7 was dropped on the wire
        s.record(9)
        s.record(10)
        s.transfer(9)

    s = _Scenario(PORT)
    s.tailer._awaiting_transfer = True
    s.transfer(5)
    assert s.tailer.synced.is_set()
    assert len(s.table.absorbed) == 1 and s.table.absorbed[0][0] == 0
    assert s.tailer.transfer_bytes == 4 * 2 * 4
    s.record(6)
    assert s.tailer.applied_watermark == 6 and len(s.table.adds) == 1
    s.record(8)
    assert Dashboard.counter_value("MIGRATION_GAP_RESYNCS") == 1
    assert s.tailer._awaiting_transfer
    assert len(s.tailer._net.subscribes()) == 1
    assert wire.decode(s.tailer._net.subscribes()[0].data)["tables"] == {0: [4, 8]}
    s.record(9)
    s.record(10)
    assert len(s.table.adds) == 1 and len(s.tailer._pretransfer) == 2
    s.transfer(9)
    assert len(s.table.absorbed) == 2
    assert s.tailer.received_watermark == 10 and s.tailer.applied_watermark == 10
    assert len(s.table.adds) == 2  # only record 10 replayed
    np.testing.assert_array_equal(s.table.adds[1][0], [1])  # donor row 5 -> 1
    _both(play)


def test_duplicate_records_never_double_apply():
    def play(s):
        s.tailer._awaiting_transfer = True
        s.transfer(3)
        s.record(4)
        s.record(4)  # dup
        s.record(3)  # stale retransmit from before the cut

    s = _both(play)
    assert len(s.table.adds) == 1
    assert s.tailer.records_applied == 1
    assert s.tailer.received_watermark == 4
    assert Dashboard.counter_value("MIGRATION_GAP_RESYNCS") == 0


def test_out_of_range_records_advance_watermark_only():
    def play(s):
        s.tailer._awaiting_transfer = True
        s.transfer(0)
        s.record(1, row=2)  # donor row 2 < donor_lo=4

    s = _both(play)
    assert s.tailer.applied_watermark == 1
    assert s.table.adds == [] and s.tailer.records_applied == 0
