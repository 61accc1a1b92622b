"""DeepSeek-V2's layers in the port (``models/deepseek_v2.py``) against the
plain float32 reference (``tests/reference/deepseek_v2.py``) at tiny widths
on the CPU: MLA with YaRN, the expert layer, the expert-parallel share
identity, the loss and every gradient of a dense + 2 MoE layer model; the
model-agnostic ASGD trainer (``ext/asgd.py``); the sections and counters
once a step; and the no-wait device readouts."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.ext import asgd
from multiverso_tpu_torch.ext.asgd import ASGDTrainer
from multiverso_tpu_torch.models import deepseek_v2 as ds
from multiverso_tpu_torch.obs.devtime import (DeviceReadout, DeviceSection,
                                              DeviceTime)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "deepseek_v2_reference", REPO / "tests" / "reference" / "deepseek_v2.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

#: Tiny widths: hidden 64, 4 heads, latent 16, rope 8, nope 16, v 16, 8
#: experts top-3, 2 shared; a dense layer then MoE layers.
TINY = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=16,
            qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2,
            first_k_dense_replace=1, vocab_size=256, rms_norm_eps=1e-6,
            rope_theta=10000, routed_scaling_factor=1.0, aux_loss_alpha=0.001,
            rope_scaling=dict(ds.YARN, original_max_position_embeddings=16))
ATOL = RTOL = 1e-5


def _configs(layers=3, first=0, held=8, **kw):
    """(port config, reference config dict) of the same tiny model."""
    d = dict(TINY, **kw)
    port = ds.DeepseekV2Config(**d, num_hidden_layers=layers,
                               experts_held=(first, held),
                               compute_dtype=torch.float32)
    rd = dict(d, layers_held=layers, n_routed_experts_held=held,
              experts_held_first=first, rope_scaling=port.rope_scaling)
    return port, rd


def _params(c, seed=0):
    """Port weights, scaled up so that routing and attention are not flat."""
    p = ds.init_params(c, seed)
    return {k: v if "norm" in k else v * 5 for k, v in p.items()}


def _tokens(b=2, t=12, vocab=256, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, t + 1), generator=g)


def _close(a, b, atol=ATOL, rtol=RTOL):
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@pytest.mark.parametrize("mscale", [(0.707, 0.707), (1.0, 0.707), (0.707, 0.0)],
                         ids=["published", "mscale_ratio", "no_mscale_all"])
def test_mla_with_yarn_matches_reference(mscale):
    c, rd = _configs(rope_scaling=dict(ds.YARN, original_max_position_embeddings=16,
                                       mscale=mscale[0], mscale_all_dim=mscale[1]))
    p = _params(c)
    t = 12
    cos, sin = ds.rope_tables(c, t, "cpu")
    rcos, rsin = ref.yarn(rd, t, "cpu")
    _close(cos, rcos, atol=1e-6, rtol=1e-6)
    _close(sin, rsin, atol=1e-6, rtol=1e-6)
    assert c.softmax_scale == pytest.approx(ref.softmax_scale(rd), rel=1e-12)
    x = torch.randn(2, t, 64, generator=torch.Generator().manual_seed(3))
    got = ds.mla_attention(p, "layers.0.self_attn.", x, (cos, sin), c)
    r = ref.Reference(rd, "cpu")
    for s in range(2):
        want = r.attention(p, "layers.0.self_attn.", x[s], rcos, rsin)
        _close(got[s], want)


def test_moe_layer_matches_reference():
    c, rd = _configs(first=2, held=4)
    p = _params(c)
    x = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(4))
    s = ds.Sections("cpu")
    y, aux, loads = ds.moe(p, "layers.1.mlp.", x, c, s)
    r = ref.Reference(rd, "cpu")
    aux_ref = 0.0
    for seq in range(2):
        want, a, ids = r.moe(p, "layers.1.mlp.", x[seq])
        _close(y[seq], want)
        aux_ref = aux_ref + a / 2
        held = ((ids >= 2) & (ids < 6))
        assert int(held.sum()) > 0
    _close(aux, aux_ref)
    assert int(loads.sum()) == sum(
        int(((r.moe(p, "layers.1.mlp.", x[q])[2] >= 2)
             & (r.moe(p, "layers.1.mlp.", x[q])[2] < 6)).sum()) for q in range(2))


def test_held_shares_sum_to_the_whole_layer():
    """Every chip's held experts' part summed, with the shared experts
    counted once, is the uncut reference layer."""
    c_all, rd_all = _configs(first=0, held=8)
    p_all = _params(c_all)
    x = torch.randn(24, 64, generator=torch.Generator().manual_seed(5))
    weights, ids, _ = ds.route(p_all, "layers.1.mlp.", x, c_all, 2)
    total = torch.zeros(24, 64)
    for first, held in ((0, 2), (2, 2), (4, 1), (5, 3)):
        c, _ = _configs(first=first, held=held)
        share = dict(p_all)
        for k in ("experts.gate_up_proj", "experts.down_proj"):
            key = "layers.1.mlp." + k
            share[key] = p_all[key][first:first + held]
        part, _ = ds.held_experts(share, "layers.1.mlp.", x, weights, ids, c)
        total += part
    total += ds._swiglu(x, p_all["layers.1.mlp.shared_experts.gate_up_proj.weight"],
                        p_all["layers.1.mlp.shared_experts.down_proj.weight"],
                        torch.float32)
    r = ref.Reference(rd_all, "cpu")
    want = torch.cat([r.moe(p_all, "layers.1.mlp.", x[:12])[0],
                      r.moe(p_all, "layers.1.mlp.", x[12:])[0]])
    _close(total, want)


def test_loss_and_every_gradient_match_reference():
    c, rd = _configs(layers=3, first=1, held=5)
    p = _params(c)
    tokens = _tokens()
    names = sorted(p)
    leaves = [p[n].clone().requires_grad_() for n in names]
    loss, ce, loads = ds.forward_loss(dict(zip(names, leaves)), tokens, c,
                                      ds.Sections("cpu"))
    grads = torch.autograd.grad(loss, leaves)
    assert loads.shape == (2, 5)
    r = ref.Reference(rd, "cpu", block=1)
    want_loss, want_grads, _ = r.loss(p, tokens, grads=True)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    assert float(ce.detach()) < float(loss.detach())
    for n, g in zip(names, grads):
        _close(g, want_grads[n], atol=1e-6, rtol=1e-4)


def test_param_shapes_match_reference_and_count():
    c, rd = _configs(layers=3, first=1, held=5)
    assert ds.param_shapes(c) == ref.shapes(rd)
    lite = ds.DeepseekV2Config(vocab_size=12800, num_hidden_layers=9,
                               experts_held=(0, 8))
    n = sum(int(np.prod(s)) for s in ds.param_shapes(lite).values())
    assert n == 936_684_032


def test_grouped_experts_match_the_loop_in_bfloat16():
    g = torch.Generator().manual_seed(6)
    loads = torch.tensor([5, 0, 7, 12])
    xs = torch.randn(24, 64, generator=g).bfloat16()
    gate_up = torch.randn(4, 64, 64, generator=g) * 0.1
    down = torch.randn(4, 64, 32, generator=g) * 0.1
    _close(ds.experts_grouped(xs, gate_up, down, loads).float(),
           ds.experts_loop(xs, gate_up, down, loads).float(),
           atol=1e-2, rtol=1e-2)


# -- the model-agnostic ASGD trainer ---------------------------------------------

@pytest.fixture
def port():
    FLAGS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    Dashboard.reset()
    try:
        yield mvt
    finally:
        if mvt.Zoo.instance().started:
            mvt.shutdown()
        FLAGS.reset()
        torch.set_num_threads(threads)


def _adder(delta):
    def make_step(slot):
        def step(state, batch):
            with torch.no_grad():
                state["params"]["w"].add_(delta[slot] * batch)
            return state, torch.zeros(())
        return step
    return make_step


def test_asgd_one_worker_table_equals_its_params(port):
    port.init(device="cpu", local_workers=1)
    trainer = ASGDTrainer({"w": torch.arange(6.0)}, workers=1, sync_freq=1)
    results = trainer.run(_adder({0: torch.ones(6)}), lambda s: [1.0, 2.0])
    table = np.asarray(trainer.manager.table.get())
    np.testing.assert_array_equal(table, results[0]["params"]["w"].numpy())
    np.testing.assert_array_equal(table, np.arange(6.0) + 3.0)
    assert len(trainer.sync_seconds) == 2


def test_asgd_two_workers_table_holds_both_deltas(port):
    port.init(device="cpu", local_workers=2)
    trainer = ASGDTrainer({"w": torch.zeros(4)}, workers=2, sync_freq=1)
    trainer.run(_adder({0: torch.ones(4), 1: torch.full((4,), 10.0)}),
                lambda s: [1.0] * (3 if s == 0 else 2))
    np.testing.assert_array_equal(trainer.manager.table.get(),
                                  np.full(4, 3 * 1.0 + 2 * 10.0))


class _PassedEvent:
    """A CUDA timing event's surface, passed by the device at once."""

    def record(self):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.0


def test_asgd_times_each_sync_on_the_device(port, monkeypatch):
    """On a card each sync of the loop is one pair of the worker's device
    timer (``ASGD_SYNC_DEVICE``), all harvested before ``run`` returns:
    here a timer of another name (the registry keeps every name it has
    seen) with events that pass at once. The sync after the last step is
    not timed."""
    assert asgd._device_timer("cpu") is None
    monkeypatch.setattr(asgd, "_device_timer", lambda device: DeviceTime(
        "TEST_ASGD_SYNC_PAIRS", event=_PassedEvent))
    port.init(device="cpu", local_workers=1)
    trainer = ASGDTrainer({"w": torch.zeros(3)}, workers=1, sync_freq=1)
    trainer.run(_adder({0: torch.ones(3)}), lambda s: [1.0, 2.0, 3.0])
    timed = Dashboard.watch("TEST_ASGD_SYNC_PAIRS")
    assert timed.count == Dashboard.watch("ASGD_SYNC").count == 3
    assert timed.elapse_ms == pytest.approx(3 * 2.0)


def test_lm_trainer_sections_and_counters_once_a_step(port):
    port.init(device="cpu", local_workers=1)
    c, _ = _configs(layers=3, first=1, held=5)
    trainer = ds.LMTrainer(c, _params(c), ds.AdamWConfig(lr=1e-3))
    losses = []
    batches = [_tokens()] * 3
    trainer.train(lambda slot: iter(batches), lambda s, l: losses.append(float(l)))
    steps, moe_layers = 3, 2
    snap = Dashboard.snapshot()
    counts = {k: v["count"] for k, v in snap["monitors"].items()}
    assert counts["MLA_ATTENTION"] == 3 * steps
    assert counts["MOE_ROUTE"] == counts["MOE_EXPERTS"] == moe_layers * steps
    assert counts["MOE_SHARED"] == moe_layers * steps
    assert counts["LM_OPTIM"] == counts["ASGD_SYNC"] == steps
    assert not any(k.endswith("_DEVICE") for k in counts)   # CPU: no events
    n = sum(int(np.prod(s)) for s in ds.param_shapes(c).values())
    assert snap["counters"]["ASGD_SYNC_BYTES"] == steps * 2 * 4 * n
    pairs = snap["counters"]["MOE_ROUTED_PAIRS"]
    assert 0 < pairs <= steps * moe_layers * 2 * 12 * 3
    assert snap["gauges"]["MOE_LOAD_MAX_RATIO"] >= 1.0
    assert losses[-1] < losses[0]
    # AdamW state carries over: a second call goes on from step 4
    trainer.train(lambda slot: iter(batches[:1]))
    assert float(trainer.states[0]["step"]["norm.weight"]) == 4.0


# -- device readouts without a card --------------------------------------------------

def test_device_section_on_cpu_times_the_host_only():
    Dashboard.reset()
    s = DeviceSection("TEST_DS_SECTION", "cpu")
    x = torch.ones(3, requires_grad=True)
    with s():
        y = s.leave(s.enter(x) * 2)
    assert y.requires_grad and s.timer is None
    y.sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    assert Dashboard.watch("TEST_DS_SECTION").count == 1
    assert Dashboard.watch("TEST_DS_SECTION_DEVICE") is None


def test_device_readout_on_cpu_hands_over_at_once():
    got = []
    r = DeviceReadout(got.append)
    t = torch.arange(4)
    r.submit(t)
    t.add_(1)                      # the readout holds its own copy
    r.flush()
    assert len(got) == 1 and torch.equal(got[0], torch.arange(4))


# -- the catalog's rows of these sections --------------------------------------------

CATALOG_HEADING = "### The port's language model and ASGD trainer"


def _catalogued():
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


def test_the_catalog_lists_the_lm_sections():
    assert set(_catalogued()) >= {
        "MLA_ATTENTION", "MOE_ROUTE", "MOE_EXPERTS", "MOE_SHARED", "LM_OPTIM",
        "ASGD_SYNC", "MOE_ROUTED_PAIRS", "MOE_LOAD_MAX_RATIO",
        "ASGD_SYNC_BYTES"}


@pytest.mark.parametrize("name", _catalogued())
def test_catalogued_lm_section_is_named_in_the_port(name):
    """The rows carry an mvlint suppression (the JAX package emits none of
    them), which also turns off the port's own check for a catalogued name
    that nothing emits any more: this stands in for it."""
    base = re.sub(r"_DEVICE$", "", name)
    found = any(base in p.read_text() for p in
                (REPO / "multiverso_tpu_torch").rglob("*.py"))
    assert found
