"""The idle-gap label that names the port's own sections
(``sections.py``): on synthetic ranges, and the sections picked out of a
profile's events."""

import torch

import sections


# -- the gap label ------------------------------------------------------------

GAP = (100.0, 200.0)


def test_label_keeps_the_bench_label_where_no_section_covers_the_gap():
    outside = [(0.0, 90.0, "MATRIX_ADD_STAGE", 1),
               (210.0, 300.0, "MATRIX_ADD_MERGE", 1)]
    assert sections.label(GAP, [], "bench.add") == "bench.add"
    assert sections.label(GAP, outside, "bench.add") == "bench.add"


def test_label_names_the_leaf_sections_over_the_gap():
    spans = [(90.0, 210.0, "SERVER_PROCESS_ADD_MSG", 1),   # parent of both
             (95.0, 150.0, "MATRIX_ADD_MERGE", 1),
             (150.0, 205.0, "MATRIX_ADD_STAGE", 1),
             (50.0, 400.0, "WORKER_TABLE_SYNC_ADD", 2)]    # waits: not named
    assert (sections.label(GAP, spans, "bench.add")
            == "bench.add|MATRIX_ADD_MERGE+MATRIX_ADD_STAGE")


def test_label_keeps_sections_covering_half_the_largest():
    spans = [(100.0, 180.0, "MATRIX_ADD_STAGE", 1),
             (180.0, 200.0, "MATRIX_ADD_SCATTER", 1)]
    assert (sections.label(GAP, spans, "bench.add")
            == "bench.add|MATRIX_ADD_STAGE")


def test_label_names_a_waiting_section_only_where_nothing_works():
    spans = [(0.0, 300.0, "W2V_FINISH_WAIT", 1),
             (0.0, 300.0, "WORKER_TABLE_SYNC_GET", 2)]
    assert (sections.label(GAP, spans, "bench.finish_block")
            == "bench.finish_block|W2V_FINISH_WAIT+WORKER_TABLE_SYNC_GET")
    spans.append((120.0, 190.0, "W2V_TXN_STEP", 3))
    assert (sections.label(GAP, spans, "bench.finish_block")
            == "bench.finish_block|W2V_TXN_STEP")


def test_a_section_nested_on_another_thread_does_not_hide_a_leaf():
    spans = [(100.0, 200.0, "W2V_SHAPE", 1),
             (120.0, 140.0, "W2V_TXN_GATHER", 2)]
    assert (sections.label(GAP, spans, "bench.submit_block")
            == "bench.submit_block|W2V_SHAPE")


def test_program_spans_are_the_port_sections_of_a_profile():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.add"):
            with torch.profiler.record_function("MATRIX_ADD_STAGE"):
                torch.ones(4).sum()
    spans = sections.program_spans(prof.events())
    assert [name for _, _, name, _ in spans] == ["MATRIX_ADD_STAGE"]
    start, end, _, _ = spans[0]
    assert end >= start
