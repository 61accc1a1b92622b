"""The port's wire against the JAX package's, byte for byte.

The codec (``runtime/wire.py``) turns every structure of
``tests/test_remote.py``'s codec cases — the ``AddOption``/``GetOption``
envelopes, dicts, nested tuples, numeric lists, sparse-compressed and
quantized deltas — into the same blobs in both packages, and the frame
assembly (``runtime/net.py``) turns the same ``Message`` into the same
bytes, the deadline field and its zero included. The dashboards render
the same Prometheus text and snapshot for the same metrics, and the
codec is monitored as in ``tests/test_foundations.py``. With
``trace_dir`` set, the port records a ``torch.profiler`` trace in which
the dispatcher's monitor sections are named scopes."""

import json
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.dashboard import Dashboard as JDashboard
from multiverso_tpu.runtime import net as jnet
from multiverso_tpu.runtime import wire as jwire
from multiverso_tpu.runtime.message import Message as JMessage
from multiverso_tpu.runtime.message import MsgType as JMsgType
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu.updaters import GetOption as JGetOption
from multiverso_tpu.utils.quantization import ErrorFeedback as JErrorFeedback

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.obs.metrics import StatsSnapshot, merge_stats
from multiverso_tpu_torch.runtime import net as tnet
from multiverso_tpu_torch.runtime import wire as twire
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.updaters import AddOption, GetOption
from multiverso_tpu_torch.utils.quantization import ErrorFeedback


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags and dashboard from their defaults; whatever a test
    starts is stopped (tests/conftest.py resets the JAX side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see tests/test_torch_sync.py's fixture
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    Dashboard.reset()
    yield
    try:
        if Zoo.instance().started:
            mvt.shutdown()
    finally:
        Zoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _cases(add_opt, get_opt, feedback):
    """The codec cases of tests/test_remote.py, built with one package's
    option and error-feedback classes (same arguments in both)."""
    rng = np.random.default_rng(0)
    sparse = np.zeros((64, 128), np.float32)
    sparse[5, :7] = 1.5
    sparse[40, 2] = -2.0
    delta = np.random.default_rng(1).standard_normal((64, 128)).astype(
        np.float32)
    return {
        "none": (None, False),
        "int": (7, False),
        "float": (3.25, False),
        "str": ("hello", False),
        "bool": (True, False),
        "numeric_list": ([1, 2, 3], False),
        "add_request": ((None, np.arange(6, dtype=np.int32),
                         add_opt(worker_id=3)), False),
        "register_reply": ({"worker_id": 5, "tables": [
            {"kind": "array", "size": 8}]}, False),
        "kv_dict": ({1: 2.5, 7: 3.5}, False),
        "get_option": (get_opt(worker_id=9), False),
        "nested": ((np.zeros((4, 3), np.float32), [10, 20], "tail"), False),
        "adagrad_option": ((np.arange(3, dtype=np.int32),
                            rng.standard_normal((3, 5)).astype(np.float32),
                            add_opt(worker_id=2, momentum=0.5,
                                    learning_rate=0.1, rho=0.1,
                                    lambda_=0.01)), False),
        "sparse_compressed": (sparse, True),
        "dense_compress_flag": (delta, True),
        "quantized_4bit": ((None, feedback(delta.shape, 4).compress(delta),
                            None), False),
        "quantized_rows_8bit": ((np.arange(64, dtype=np.int32),
                                 feedback(delta.shape, 8).compress(
                                     delta, np.arange(64)), None), False),
    }


CASES = list(_cases(AddOption, GetOption, ErrorFeedback))


def _blobs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_codec_blobs_byte_identical(case):
    """Every codec case encodes to the same blobs in both packages, and
    each package decodes the other's blobs to an equal structure."""
    obj_t, compress = _cases(AddOption, GetOption, ErrorFeedback)[case]
    obj_j, _ = _cases(JAddOption, JGetOption, JErrorFeedback)[case]
    blobs_t = twire.encode(obj_t, compress=compress)
    blobs_j = jwire.encode(obj_j, compress=compress)
    _blobs_equal(blobs_t, blobs_j)
    # each side decodes the other's bytes; the two results agree
    _blobs_equal(twire.encode(twire.decode(blobs_j)),
                 jwire.encode(jwire.decode(blobs_t)))


def test_sparse_compression_engages_in_both():
    arr = np.zeros((64, 128), np.float32)
    arr[5, :7] = 1.5
    tree = bytes(np.asarray(twire.encode(arr, compress=True)[0], np.uint8))
    assert b'"sparse"' in tree
    np.testing.assert_array_equal(
        twire.decode(jwire.encode(arr, compress=True)), arr)


def _message(cls, type_cls, **kw):
    rng = np.random.default_rng(3)
    base = dict(src=2, dst=0, type=type_cls.Request_Add, table_id=4,
                msg_id=17, req_id=(5 << 32) | 9, watermark=-1,
                data=[rng.standard_normal((16, 8)).astype(np.float32),
                      np.arange(5, dtype=np.int64),
                      np.float32(2.5).reshape(()),
                      np.zeros(0, np.float32)])
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("deadline,trace", [
    (0.0, False),        # no deadline: the field stays 0
    (1000.5, False),     # 0.5 s of budget left at encode
    (999.0, False),      # expired at encode: ships the 1 µs floor
    (0.0, True),         # the trace flag on the channel byte
], ids=["no_deadline", "budget", "expired", "traced"])
def test_frame_bytes_identical(monkeypatch, deadline, trace):
    """Both packages frame the same Message into the same bytes, header
    and payload: magic, version, ids, req_id, watermark, the remaining
    deadline budget in µs, blob heads and the CRC."""
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    frame_t = tnet.TcpNet()._frame(
        _message(Message, MsgType, deadline=deadline, trace=trace), 0)
    frame_j = jnet.TcpNet()._frame(
        _message(JMessage, JMsgType, deadline=deadline, trace=trace), 0)
    assert frame_t == frame_j
    header = tnet._HEADER.unpack(frame_t[: tnet._HEADER.size])
    want_us = {0.0: 0, 1000.5: 500000, 999.0: 1}[deadline]
    assert header[10] == want_us


def _populate(dash, bounds):
    """The same metrics into one package's dashboard module."""
    dash.count("SERVER_DEDUP_HITS", 3)
    dash.count("TENANT_ctr_SHED", 2)
    dash.gauge_set("SERVER_QUEUE_DEPTH", 7)
    dash.gauge_set("ROUTER_SHARD3_SECONDS", 0.5)
    for v in (1e-5, 3e-4, 2e-3, 0.05):
        dash.observe("SERVER_PROCESS_ADD_MSG", v)
    dash.Dashboard.histogram("APPLY_BATCH_ROWS",
                             bounds=bounds(lowest=1.0)).observe(1024)


def test_prometheus_render_and_snapshot_match_jax(monkeypatch):
    """The same metrics render the same Prometheus exposition (labels,
    tenant and shard families, cumulative buckets) and snapshot in both
    dashboards."""
    from multiverso_tpu import dashboard as jdash
    from multiverso_tpu.obs.metrics import log_bounds as jlog_bounds
    from multiverso_tpu_torch import dashboard as tdash
    # both registries empty for this test: a family renders in the order
    # it was registered, and what earlier tests of the same process
    # registered (a dispatcher registers APPLY_BATCH_ROWS when it starts,
    # a router its ROUTER_SHARD<k>_SECONDS) is not this test's subject
    for dash in (JDashboard, Dashboard):
        for registry in ("_monitors", "_counters", "_histograms", "_gauges"):
            monkeypatch.setattr(dash, registry, {})
    JDashboard.reset()
    _populate(jdash, jlog_bounds)
    _populate(tdash, tdash.log_bounds)
    mv.set_flag("metrics_role", "primary")
    mvt.set_flag("metrics_role", "primary")
    want = JDashboard.render(format="prom")
    got = Dashboard.render(format="prom")
    # the registries hold more than this test's metrics: compare the lines
    # of the families populated here
    names = ("dedup_hits", "tenant_shed", "queue_depth", "router_seconds",
             "process_add_msg", "apply_batch_rows")
    pick = lambda text: [ln for ln in text.splitlines()
                         if any(n in ln for n in names)]
    assert pick(got) == pick(want) and pick(got)
    jsnap, tsnap = JDashboard.snapshot(), Dashboard.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        for name in ("SERVER_DEDUP_HITS", "SERVER_QUEUE_DEPTH",
                     "APPLY_BATCH_ROWS", "SERVER_PROCESS_ADD_MSG"):
            if name in jsnap[kind]:
                assert tsnap[kind][name] == jsnap[kind][name]


def test_stats_snapshot_merge_by_bucket_addition():
    a = StatsSnapshot({"counters": {"X": 2}, "gauges": {"G": 1.0},
                       "monitors": {"M": {"count": 2, "elapse_ms": 4.0}},
                       "histograms": {}})
    Dashboard.reset()
    for v in (1e-3, 2e-3):
        Dashboard.histogram("H").observe(v)
    b = StatsSnapshot(Dashboard.snapshot())
    merged = merge_stats([a, b, b])
    assert merged.counter("X") == 2
    assert merged.histogram("H").count == 4
    assert merged.monitors["M"]["average_ms"] == 2.0
    assert merged.shards == [a, b, b]


def test_wire_codec_is_monitored():
    """tests/test_foundations.py's case on the port: the codec's encode
    and decode are timed sections."""
    payload = {"x": np.arange(8, dtype=np.float32), "n": 3}
    out = twire.decode(twire.encode(payload))
    np.testing.assert_array_equal(out["x"], payload["x"])
    assert Dashboard.watch("WIRE_ENCODE").count == 1
    assert Dashboard.watch("WIRE_DECODE").count == 1


def test_trace_dir_records_profiler_trace_with_monitor_scopes(tmp_path):
    """``trace_dir``: a torch.profiler trace spans init to shutdown and the
    dispatcher's monitor sections appear in it by name (the JAX package's
    jax.profiler trace and TraceAnnotation scopes)."""
    trace_dir = tmp_path / "trace"
    mvt.init(trace_dir=str(trace_dir))
    try:
        assert Dashboard.profile_annotations
        t = mvt.create_table("matrix", 16, 4)
        t.add(np.ones((16, 4), np.float32))
        t.get()
    finally:
        mvt.shutdown()
    assert not Dashboard.profile_annotations
    files = list(trace_dir.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "SERVER_PROCESS_ADD_MSG" in names
