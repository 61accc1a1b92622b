"""The check that decides ``correct``, on the CPU at test size: the port
agrees with the plain reference; the reference put in the program's place
in a lower precision does not; and a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have."""

import numpy as np
import pytest

import run as runner

MATRIX = ["matrix.perf_cycle"]
W2V = ["w2v.ps", "w2v.device"]


def _numbers(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("workload", MATRIX + W2V)
def test_port_agrees_with_reference(tiny_spec, workload):
    out = runner.run_spec(tiny_spec(workload))
    assert out["failed"] == 0
    assert out["correct"], _numbers(out)
    assert out["attempted"] > 0


@pytest.mark.parametrize("workload", MATRIX)
def test_matrix_control_in_bfloat16_fails(tiny_spec, workload):
    out = runner.run_spec(tiny_spec(workload, system="control"))
    assert not out["correct"]
    assert out["checks"]["table_gap"]["value"] > out["checks"]["table_gap"]["limit"]


def test_matrix_port_in_float16_fails(tiny_spec, monkeypatch):
    """A lower-precision run of the port itself: its table in float16."""
    spec = tiny_spec("matrix.perf_cycle")
    spec.cell.config = dict(spec.cell.config, dtype="float16")
    out = runner.run_spec(spec)
    assert not out["correct"]


@pytest.mark.parametrize("workload", W2V)
def test_w2v_control_in_tf32_fails(tiny_spec, workload):
    """The reference in the program's place with its products' inputs
    rounded to TF32."""
    out = runner.run_spec(tiny_spec(workload, system="control"))
    assert not out["correct"], _numbers(out)


@pytest.mark.parametrize("workload", W2V)
def test_w2v_half_batch_fault_fails(tiny_spec, workload):
    assert not runner.run_spec(tiny_spec(workload, system="half"))["correct"]


# -- faults planted in the port -------------------------------------------------

def _drop_one_add(monkeypatch):
    """A step that returns its state unchanged: the table's 5th row Add is
    acknowledged but never applied."""
    from multiverso_tpu_torch.tables import matrix_table
    orig = matrix_table.MatrixServer.process_add
    seen = {"n": 0}

    def process_add(self, request):
        seen["n"] += 1
        if seen["n"] == 5:
            return None
        return orig(self, request)

    monkeypatch.setattr(matrix_table.MatrixServer, "process_add", process_add)


def _half_of_each_add(monkeypatch):
    """Half of the batch left out: the scatter adds the first half of its
    rows only."""
    from multiverso_tpu_torch.tables import matrix_table
    orig = matrix_table.scatter_add_rows

    def scatter(table, ids, deltas):
        n = ids.shape[0] // 2
        return orig(table, ids[:n], deltas[:n])

    monkeypatch.setattr(matrix_table, "scatter_add_rows", scatter)


def _alter_an_answer(monkeypatch):
    """An answer altered where it is produced: the server's 3rd Get reply
    has its first row off by half a delta's scale."""
    from multiverso_tpu_torch.tables import matrix_table
    orig = matrix_table.MatrixServer.process_get
    seen = {"n": 0}

    def process_get(self, request):
        out = orig(self, request)
        seen["n"] += 1
        if seen["n"] == 3:
            out = out.copy()
            out[0] += 0.5
        return out

    monkeypatch.setattr(matrix_table.MatrixServer, "process_get", process_get)


@pytest.mark.parametrize("fault", [_drop_one_add, _half_of_each_add,
                                   _alter_an_answer])
def test_matrix_faults_fail(tiny_spec, monkeypatch, fault):
    fault(monkeypatch)
    out = runner.run_spec(tiny_spec("matrix.perf_cycle"))
    assert not out["correct"], _numbers(out)


def _unchanged_state(monkeypatch):
    """Every step leaves its tables as they were."""
    from multiverso_tpu_torch.models import word2vec
    monkeypatch.setattr(word2vec, "_add_rows", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Half of each block left out, the loss the mean over the rest."""
    from multiverso_tpu_torch.models import word2vec
    orig = word2vec.subsample_block
    monkeypatch.setattr(word2vec, "subsample_block",
                        lambda block, keep, rng: orig(block, keep, rng)[
                            : (len(block) + 1) // 2])


def _altered_token(monkeypatch):
    """A token altered where it is produced: each kept block's first token
    becomes the next word id."""
    from multiverso_tpu_torch.models import word2vec
    orig = word2vec.subsample_block

    def sub(block, keep, rng):
        out = orig(block, keep, rng).copy()
        out[0] = (out[0] + 1) % len(keep)
        return out

    monkeypatch.setattr(word2vec, "subsample_block", sub)


@pytest.mark.parametrize("workload", W2V)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_token])
def test_w2v_faults_fail(tiny_spec, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = runner.run_spec(tiny_spec(workload))
    assert not out["correct"], _numbers(out)


def test_get_check_holds_each_get_to_its_phase():
    """A cycle's first Get must see the Adds of the cycles before it and
    not its own cycle's; its second Get must see those too."""
    from types import SimpleNamespace
    from conftest import BENCH
    import harness
    ref = harness._module(BENCH / "reference" / "ps_matrix_1m50.py", "ref_t")
    traffic = SimpleNamespace(
        rows={10: np.array([0, 2], np.int32)},
        deltas=[{10: np.ones((2, 3), np.float32)},
                {10: 2 * np.ones((2, 3), np.float32)}])
    adds = [ref.Add(0, 0, 10), ref.Add(1, 0, 10), ref.Add(0, 1, 10)]
    table = np.zeros((4, 3), np.float32)
    table[[0, 2]] = 4.0
    for half, row, ok in ((0, 3.0, True), (0, 0.0, False), (1, 4.0, True),
                          (1, 3.0, False)):
        reply = np.zeros((4, 3), np.float32)
        reply[[0, 2]] = row
        gets = [ref.Get(1, 1, half, reply)]
        gaps = ref.check(adds, gets, table, traffic, "cpu")
        assert gaps["table_gap"] == 0.0
        assert (gaps["get_gap"] < 1e-6) == ok, (half, row, gaps)
