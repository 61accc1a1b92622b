"""The port's timed sections inside the parameter server's row path and the
word2vec trainers (``dashboard.monitor``): each request or submission
records each of its sections once, the byte counter of the host read, the
dispatcher queue's wait (one a message, also in a fused batch), the
sections' nesting in a profiler trace, and the non-blocking harvest of the
transaction's device time by CUDA events (stub events here). On the CPU:
counts and nesting, no device times."""

import ast
import json
import re
import threading
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.models import word2vec as tw
from multiverso_tpu_torch.models.vocab import Dictionary

REPO = Path(__file__).resolve().parents[1]
ADD_SECTIONS = ("MATRIX_ADD_MERGE", "MATRIX_ADD_STAGE", "MATRIX_ADD_SCATTER")
SUBMIT_SECTIONS = ("W2V_SUBSAMPLE", "W2V_SHAPE", "W2V_UPLOAD",
                   "W2V_TXN_GATHER", "W2V_TXN_STEP", "W2V_TXN_PUSH",
                   "W2V_FINISH_WAIT")


@pytest.fixture
def port():
    """Starts the port's runtime on the CPU with the test's flags; stopped
    after the test."""
    FLAGS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def start(**flags):
        mvt.init(device="cpu", **flags)
        return mvt

    try:
        yield start
    finally:
        if mvt.Zoo.instance().started:
            mvt.shutdown()
        FLAGS.reset()
        torch.set_num_threads(threads)


def _count(name):
    mon = Dashboard.watch(name)
    return 0 if mon is None else mon.count


def _hist_count(name):
    return Dashboard.histogram(name).count


@pytest.mark.parametrize("get_rows", [False, True], ids=["whole", "rows"])
def test_matrix_add_and_get_record_each_section_once(port, get_rows):
    rows, cols = 40, 6
    port()
    table = mvt.create_table("matrix", rows, cols, np.float32)
    Dashboard.reset()
    ids = np.array([3, 7, 3, 11], np.int32)  # a duplicate: the merge sums it
    table.add(np.ones((4, cols), np.float32), row_ids=ids)
    got = table.get(np.array([3, 7], np.int32)) if get_rows else table.get()
    assert got.shape == ((2 if get_rows else rows), cols)
    for name in ADD_SECTIONS + ("SERVER_QUEUE_WAIT_ADD",
                                "SERVER_QUEUE_WAIT_GET", "SERVER_HOST_READ"):
        assert _count(name) == 1, name
        assert _hist_count(name) == 1, name
    read_rows = 2 if get_rows else rows
    assert (Dashboard.counter_value("SERVER_HOST_READ_BYTES")
            == read_rows * cols * 4)
    # the sections lie inside the dispatcher's apply, the wait before it
    add_ms = sum(Dashboard.get(n).elapse_ms for n in ADD_SECTIONS)
    assert add_ms <= Dashboard.get("SERVER_PROCESS_ADD_MSG").elapse_ms
    assert (Dashboard.get("SERVER_HOST_READ").elapse_ms
            <= Dashboard.get("SERVER_PROCESS_GET_MSG").elapse_ms)
    assert (Dashboard.get("SERVER_QUEUE_WAIT_ADD").elapse_ms
            <= Dashboard.get("WORKER_TABLE_SYNC_ADD").elapse_ms)


def test_whole_table_read_bytes_are_rows_times_columns(port):
    port()
    table = mvt.create_table("matrix", 1000, 50, np.float32)
    Dashboard.reset()
    table.get()
    table.get()
    assert Dashboard.counter_value("SERVER_HOST_READ_BYTES") == 2 * 1000 * 50 * 4
    assert _count("SERVER_HOST_READ") == 2


def _adds_behind_a_held_dispatcher(table, workers, rows, hold):
    """Each worker queues one Add of ``rows`` rows while the dispatcher is
    held for ``hold`` seconds, so that one drain finds them all."""
    gate = threading.Event()
    blocker = threading.Thread(target=mvt.Zoo.instance().server.run_serialized,
                               args=(lambda: gate.wait(30),))
    blocker.start()
    pending = []
    for w in range(workers):
        with mvt.worker(w):
            pending.append(table.add_async(
                np.ones((rows, table.num_col), np.float32),
                row_ids=np.arange(w * rows, (w + 1) * rows)))
    time.sleep(hold)
    gate.set()
    for msg_id in pending:
        table.wait(msg_id)
    blocker.join(timeout=30)
    assert not blocker.is_alive()


def test_fused_batch_observes_one_queue_wait_per_message(port):
    """Four Adds queued behind a held dispatcher drain as one fused apply;
    each records its own wait, every one at least the hold."""
    hold = 0.2
    port(local_workers=4)
    table = mvt.create_table("matrix", 64, 4, np.float32)
    Dashboard.reset()
    _adds_behind_a_held_dispatcher(table, 4, 2, hold)
    assert Dashboard.counter_value("APPLY_FUSED_CALLS") == 1
    assert Dashboard.counter_value("APPLY_BATCHED_MSGS") == 4
    assert _count("SERVER_MERGE_ADDS") == 1
    wait = Dashboard.get("SERVER_QUEUE_WAIT_ADD")
    assert wait.count == 4
    assert _hist_count("SERVER_QUEUE_WAIT_ADD") == 4
    assert wait.elapse_ms >= 4 * hold * 1e3
    np.testing.assert_array_equal(table.get()[:8], np.ones((8, 4)))


def test_a_merge_that_fuses_nothing_is_timed(port):
    """Adds each over ``apply_batch_rows`` cannot fuse: the merge tried on
    the drain consumes one Add, is thrown away, and each Add applies
    alone; the try is its own section."""
    port(local_workers=2, apply_batch_rows=8)
    table = mvt.create_table("matrix", 64, 4, np.float32)
    Dashboard.reset()
    _adds_behind_a_held_dispatcher(table, 2, 10, 0.05)
    assert _count("SERVER_MERGE_ADDS") == 1
    assert Dashboard.counter_value("APPLY_FUSED_CALLS") == 0
    assert _count("SERVER_PROCESS_ADD_MSG") == 2
    assert _count("SERVER_QUEUE_WAIT_ADD") == 2
    np.testing.assert_array_equal(table.get()[:20], np.ones((20, 4)))


def test_dispatch_section_is_gone(port):
    port()
    table = mvt.create_table("matrix", 8, 2, np.float32)
    table.add(np.ones((8, 2), np.float32))
    table.get()
    assert _count("SERVER_PROCESS_ADD_MSG") >= 1
    assert "SERVER_DISPATCH_MSG" not in Dashboard.snapshot()["monitors"]
    assert "SERVER_DISPATCH_MSG" not in Dashboard.snapshot()["histograms"]


def _dictionary(vocab):
    d = Dictionary()
    d.words = [f"w{i}" for i in range(vocab)]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.maximum((1000 / np.arange(1, vocab + 1)).astype(np.int64), 5)
    return d


def _block(vocab, n, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def test_ps_trainer_submission_records_each_section_once(port):
    vocab = 60
    port()
    cfg = tw.Word2VecConfig(vocab_size=vocab, dim=8, window=2, negatives=3,
                            batch_pairs=256, block_tokens=64, sample=1e-2)
    trainer = tw.PSTrainer(cfg, _dictionary(vocab))
    Dashboard.reset()
    pend = trainer.submit_block(_block(vocab, 600))
    assert pend is not None and "txn" in pend
    trainer.finish_block(pend)
    for name in SUBMIT_SECTIONS:
        assert _count(name) == 1, name
        assert _hist_count(name) == 1, name
    # the transaction's phases are nested in its dispatcher section
    txn_ms = sum(Dashboard.get(f"W2V_TXN_{p}").elapse_ms
                 for p in ("GATHER", "STEP", "PUSH"))
    assert txn_ms <= Dashboard.get("SERVER_PROCESS_TRANSACT").elapse_ms
    # a transaction is an Add: its wait in the dispatcher queue is timed
    assert _count("SERVER_QUEUE_WAIT_ADD") >= 1
    # device time by CUDA events only
    assert _count("SERVER_TRANSACT_DEVICE") == 0


def test_device_trainer_step_records_its_three_sections(port):
    vocab = 60
    cfg = tw.Word2VecConfig(vocab_size=vocab, dim=8, window=2, negatives=3,
                            block_tokens=64, sample=1e-2)
    trainer = tw.DeviceTrainer(cfg, _dictionary(vocab), device="cpu")
    Dashboard.reset()
    loss = trainer.train_block(_block(vocab, 512))
    assert np.isfinite(loss)
    for name in ("W2V_SUBSAMPLE", "W2V_BLOCK_ISSUE", "W2V_BLOCK_SYNC"):
        assert _count(name) == 1, name
        assert _hist_count(name) == 1, name


def _trace_events(tmp_path, drive):
    """Run ``drive`` between init and shutdown with a ``trace_dir``
    profiler trace; return its complete events."""
    trace_dir = tmp_path / "trace"
    mvt.init(device="cpu", trace_dir=str(trace_dir))
    try:
        drive()
    finally:
        mvt.shutdown()
    files = list(trace_dir.glob("trace_*.json"))
    assert len(files) == 1
    return [e for e in json.loads(files[0].read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _nested(events, inner, outer):
    """Every ``inner`` range lies inside an ``outer`` range of its thread."""
    outers = [e for e in events if e["name"] == outer]
    inners = [e for e in events if e["name"] == inner]
    assert inners, f"no {inner} in the trace"
    for e in inners:
        assert any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                   for o in outers), f"{inner} outside {outer}"


def test_row_path_sections_nest_in_the_dispatcher_ranges_of_a_trace(port, tmp_path):
    def drive():
        table = mvt.create_table("matrix", 32, 4, np.float32)
        table.add(np.ones((3, 4), np.float32), row_ids=[1, 5, 9])
        table.get()

    events = _trace_events(tmp_path, drive)
    for name in ADD_SECTIONS:
        _nested(events, name, "SERVER_PROCESS_ADD_MSG")
    _nested(events, "SERVER_HOST_READ", "SERVER_PROCESS_GET_MSG")


def test_transaction_phases_nest_in_the_transaction_range_of_a_trace(port, tmp_path):
    vocab = 60

    def drive():
        cfg = tw.Word2VecConfig(vocab_size=vocab, dim=8, window=2,
                                negatives=3, batch_pairs=256, block_tokens=64)
        trainer = tw.PSTrainer(cfg, _dictionary(vocab))
        trainer.finish_block(trainer.submit_block(_block(vocab, 400)))

    events = _trace_events(tmp_path, drive)
    for phase in ("GATHER", "STEP", "PUSH"):
        _nested(events, f"W2V_TXN_{phase}", "SERVER_PROCESS_TRANSACT")
    _nested(events, "SERVER_PROCESS_TRANSACT", "SERVER_PROCESS_ADD_MSG")


class _StubEvent:
    """A CUDA event stand-in: ``record`` stamps a time, ``query`` says
    whether the device has passed it; anything that would wait fails."""

    clock = [0.0]

    def __init__(self):
        self.done = False
        self.at = None
        self.queries = 0

    def record(self):
        self.at = self.clock[0]

    def query(self):
        self.queries += 1
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time on a pending pair"
        return (end.at - self.at) * 1e3  # ms, as CUDA events give it

    def synchronize(self):
        raise AssertionError("the harvest must never wait")

    wait = synchronize


def test_device_time_harvest_observes_only_finished_pairs():
    Dashboard.reset()
    name = "TEST_DEVICE_TIME_HARVEST"
    made = []

    def event():
        made.append(_StubEvent())
        return made[-1]

    timer = tw.DeviceTime(name, event=event)
    clock = _StubEvent.clock
    clock[0] = 1.0
    first = timer.begin()
    clock[0] = 1.25
    timer.end(first)
    clock[0] = 2.0
    second = timer.begin()  # the first pair is still pending: nothing yet
    assert _count(name) == 0
    assert made[1].queries == 1
    clock[0] = 2.5
    timer.end(second)
    # the later pair finishing first changes nothing: stream order
    made[2].done = made[3].done = True
    timer.harvest()
    assert _count(name) == 0
    made[0].done = made[1].done = True
    timer.begin()
    assert _count(name) == 2
    assert _hist_count(name) == 2
    assert Dashboard.get(name).elapse_ms == pytest.approx(250.0 + 500.0)
    timer.harvest()  # harvested pairs are not seen again
    assert _count(name) == 2


# -- the catalog's rows of these sections --------------------------------------

#: The catalog's subsection of the port's sections (docs/observability.md).
CATALOG_HEADING = "### The port's row path and word2vec step"


def _catalogued_sections():
    """The names in the first column of the subsection's rows."""
    lines = (REPO / "docs" / "observability.md").read_text().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith(CATALOG_HEADING))
    names = []
    for line in lines[start + 1:]:
        if line.startswith("#"):
            break
        if line.startswith("| `"):
            names += re.findall(r"`([A-Z][A-Z0-9_]*)`", line.split("|")[1])
    return names


@lru_cache(maxsize=1)
def _port_string_constants():
    found = set()
    for path in (REPO / "multiverso_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                found.add(node.value)
    return frozenset(found)


def test_the_catalog_lists_the_port_sections():
    assert len(_catalogued_sections()) >= 18


@pytest.mark.parametrize("name", _catalogued_sections())
def test_catalogued_section_is_named_in_the_port(name):
    """The rows carry an mvlint suppression (the JAX package emits none of
    them), which also turns off the port's own check for a catalogued name
    that nothing emits any more: this stands in for it."""
    assert name in _port_string_constants()
