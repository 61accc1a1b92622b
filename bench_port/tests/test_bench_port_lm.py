"""The language-model cell (``dsv2lite.asgd_4k``): its configuration against
the catalog entry it is cut from, its manifest entries, the driver at test
size on the CPU correct against the plain reference, the control and each
planted fault not correct, the step's count by hand, and readers that hold
a bfloat16 step to the bfloat16 peak."""

import json
import re

import pytest

import counts_lm
import harness
import peaks
import run as runner
from conftest import BENCH, ROOT

CELL = "dsv2lite.asgd_4k"
MANIFEST = harness.load_manifest(ROOT)
CONFIG = json.loads((BENCH / "configs" / "dsv2_lite_ep8.json").read_text())
#: DeepSeek-V2-Lite's published config.json, as the model catalog holds it.
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "greedy", "v_head_dim": 128, "vocab_size": 102400}
NEW_METRICS = ["lm_mfu", "kernel_roofline.lm", "device_idle.lm",
               "mla_attn_ms.lm", "moe_expert_ms.lm", "asgd_sync_ms.lm"]


def _numbers(out):
    return {k: v["value"] for k, v in out["checks"].items()}


# -- the configuration and the manifest ---------------------------------------------

def test_config_is_the_published_one_but_for_its_cut():
    changed = {k for k, v in PUBLISHED.items() if CONFIG.get(k) != v}
    assert changed == {"vocab_size"}
    assert set(CONFIG["reduced"]) == {"vocab_size", "n_routed_experts_held",
                                      "layers_held"}
    assert CONFIG["vocab_size"] * 8 == PUBLISHED["vocab_size"]
    assert CONFIG["n_routed_experts_held"] * 8 == PUBLISHED["n_routed_experts"]
    assert CONFIG["layers_held"] >= CONFIG["first_k_dense_replace"] + 4
    for key in CONFIG["reduced"]:
        assert key in CONFIG["cut"]
    assert set(CONFIG["limits"]) == {"loss_gap", "grad1_gap",
                                     "route1_mismatch", "sync1_gap",
                                     "sync1_gap_sure"}


def test_manifest_entries_of_the_cell():
    (cfg,) = [c for c in MANIFEST["configs"] if c["name"] == "dsv2_lite_ep8"]
    assert cfg["source"] == CONFIG["source"]
    assert cfg["reduced"] == CONFIG["reduced"]
    (cell,) = [w for w in MANIFEST["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "lm_packed_4k"
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert CELL in e2e["train_tokens_per_s"]["workloads"]
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "train_tokens_per_s"
    built = harness.Cell(MANIFEST, CELL)
    assert [m["name"] for m in built.per_layer] == NEW_METRICS
    assert {m["name"] for m in built.end_to_end} == {"train_tokens_per_s",
                                                     "setup_s"}


# -- correct: the port against the reference, the control and the faults ----------------

def test_port_agrees_with_reference_at_test_size(tiny_spec):
    out = runner.run_spec(tiny_spec(CELL, trace=True))
    assert out["failed"] == 0 and out["attempted"] > 2
    assert out["correct"], _numbers(out)
    assert out["e2e"]["train_tokens_per_s"] > 0
    assert out["ctx"]["steps"] > 0 and out["ctx"]["snapshot"]["monitors"]


@pytest.mark.parametrize("system", ["control", "top5", "no_shared", "rope_nope",
                                    "no_kv_norm", "drop_delta"])
def test_control_and_faults_fail(tiny_spec, system):
    """The reference in the program's place: every matmul input rounded to
    e4m3, or one fault planted."""
    out = runner.run_spec(tiny_spec(CELL, system=system, window=False))
    assert not out["correct"], _numbers(out)


def _port_top5(monkeypatch):
    from multiverso_tpu_torch.models import deepseek_v2 as ds
    orig = ds.route

    def route(p, prefix, x, c, batch):
        w, ids, aux = orig(p, prefix, x, c, batch)
        return w[:, :-1], ids[:, :-1], aux

    monkeypatch.setattr(ds, "route", route)


def _port_drop_delta(monkeypatch):
    """The worker's sync hands back its baseline and pushes nothing."""
    from multiverso_tpu_torch.ext import param_manager
    monkeypatch.setattr(param_manager.PytreeWorkerSync, "sync",
                        lambda self, tree: self.params)


def _port_no_kv_norm(monkeypatch):
    from multiverso_tpu_torch.models import deepseek_v2 as ds
    orig = ds.rms_norm
    monkeypatch.setattr(ds, "rms_norm", lambda x, w, eps: x.float()
                        if w.shape[0] == 16 else orig(x, w, eps))


@pytest.mark.parametrize("fault", [_port_top5, _port_drop_delta,
                                   _port_no_kv_norm])
def test_faults_planted_in_the_port_fail(tiny_spec, monkeypatch, fault):
    fault(monkeypatch)
    out = runner.run_spec(tiny_spec(CELL, window=False))
    assert not out["correct"], _numbers(out)


# -- counts and readers -------------------------------------------------------------

def test_step_count_by_hand():
    cfg = dict(PUBLISHED, vocab_size=12800, layers_held=9,
               n_routed_experts_held=8)
    # an MoE layer's forward a token at T 4096: projections 2 x 13.76 M,
    # causal attention 2 x 2048.5 x 16 x 320, gate 2 x 2048 x 64, 0.75
    # routed pairs x 6 x 2048 x 1408, shared 6 x 2048 x 2816
    proj = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    attention = 2 * proj + 2 * 2048.5 * 16 * 320
    moe = 2 * 2048 * 64 + 0.75 * 6 * 2048 * 1408 + 6 * 2048 * 2816
    dense = 6 * 2048 * 10944
    head = 2 * 2048 * 12800
    forward = 9 * attention + dense + 8 * moe + head
    assert counts_lm.forward_flops_per_token(cfg, 4096) == pytest.approx(forward)
    assert counts_lm.step_flops(cfg, 8, 4096) == pytest.approx(
        3 * forward * 32768)
    assert counts_lm.step_flops(cfg, 8, 4096) == pytest.approx(98.9e12, rel=1e-3)
    assert counts_lm.params(cfg) == 936_684_032
    assert counts_lm.step_bytes(cfg) == 60 * 936_684_032


def test_readers_hold_the_step_to_the_bfloat16_peak():
    for name in NEW_METRICS:
        text = (BENCH / "metrics" / f"{name}.py").read_text()
        assert not re.search(r"FP32_FLOPS|roofline_share", text), name
    cell = harness.Cell(MANIFEST, CELL)
    flops = counts_lm.step_flops(CONFIG, 8, 4096)
    ctx = {"window_s": 2.0, "flops": 10 * flops, "steps": 10,
           "trace": {"kernel_s": 1.0, "busy_s": 1.0, "window_s": 1.25,
                     "work_flops": 2 * flops, "work_bytes": 0.0},
           "snapshot": {"monitors": {
               "MLA_ATTENTION_DEVICE": {"count": 180, "elapse_ms": 900.0},
               "MOE_EXPERTS_DEVICE": {"count": 160, "elapse_ms": 300.0},
               "ASGD_SYNC": {"count": 10, "elapse_ms": 50.0},
               "ASGD_SYNC_DEVICE": {"count": 10, "elapse_ms": 180.0}}}}
    got = {name: cell.readers[name](ctx) for name in NEW_METRICS}
    assert got["lm_mfu"] == pytest.approx(100 * 10 * flops / 2.0 / 989.4e12)
    assert got["lm_mfu"] < 100 < 100 * 10 * flops / 2.0 / peaks.FP32_FLOPS
    assert got["kernel_roofline.lm"] == pytest.approx(
        100 * 2 * flops / 989.4e12)
    assert got["device_idle.lm"] == pytest.approx(20.0)
    assert got["mla_attn_ms.lm"] == 90.0 and got["moe_expert_ms.lm"] == 30.0
    assert got["asgd_sync_ms.lm"] == 18.0    # the device's, not the host's
    assert all(cell.readers[name]({}) is None for name in NEW_METRICS)
