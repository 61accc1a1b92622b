"""A language model trained by ASGD through the parameter server (kind
``lm``): ``models/deepseek_v2.py``'s ``LMTrainer``, ``workers`` worker
threads syncing through one ``ArrayTable`` every ``sync_freq`` steps.

Traffic: documents of lognormal length (median ``doc_median`` tokens,
sigma ``doc_sigma``, clipped to [``doc_min``, ``doc_max``]), each closed by
id 0 (the separator), their tokens zipf(``zipf``) over the other ids of the
vocabulary slice through a permutation drawn from the seed, packed end to
end into one stream made on the device; a step takes ``sequences``
sequences of ``seq_len`` tokens (each with the next token for its last
label) from where the last one stopped, cycling the stream.

Set-up makes the weights on the device from the seed and hands the
trainer a host copy; drives the trainer through its first
``checked_steps`` steps by the window's own call, ``train``, over the
window's stream, step 1 alone with its gradients, routing and the table's
value after its sync read back; then ``warmup_steps`` more. The window
trains on until ``seconds`` have passed. After the window, with the port
shut down, the reference replays the checked steps from the same weights
and batches, and the check compares: ``loss_gap``, the worst step's
relative loss gap; ``grad1_gap``, the worst leaf's norm of the step-1
gradient's gap over the larger of the reference's norm of that leaf and
the median leaf's; ``route1_mismatch``, the share of step 1's (token,
slot) assignments of every MoE layer that differ from the reference's;
``sync1_gap``, the worst leaf's gap between the table's change across the
first sync and the reference's change from its first AdamW step, over the
norm of the reference's change (a dropped delta reads 1);
``sync1_gap_sure``, the same over the elements whose reference gradient
is at least ``SURE_GRAD`` of its leaf's root mean square. AdamW's first
step is about lr x sign(g) an element, so an element whose tiny gradient
changes sign under rounding moves 2 lr: ``sync1_gap`` reads those, and
``sync1_gap_sure`` leaves them out. The diagnostics give the share of
elements whose change differs in sign, the gap over the others and the
worst leaves.

On a host without a card (the benchmark's own tests) the configuration's
and the traffic's ``cpu_size`` replace their sizes, and the port computes
in float32.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import counts_lm
import devtrace
import generate

#: Seed words of this driver's streams (``generate`` uses 1-7).
DOCS, TOKENS, PERM, LM_WEIGHTS = 11, 12, 13, 14
#: ``sync1_gap_sure`` takes the elements whose reference gradient is at
#: least this share of its leaf's root mean square: far above bfloat16's
#: rounding of a gradient (the sound runs' leaves are within 2% of it in
#: norm), so no sound run flips the sign of their first AdamW step.
SURE_GRAD = 0.25


def sizes(spec):
    """(configuration, traffic) at the run's size."""
    cfg, tr = spec.cell.config, spec.cell.traffic
    if torch.device(spec.device).type != "cuda":
        cfg, tr = dict(cfg, **cfg["cpu_size"]), dict(tr, **tr["cpu_size"])
    return cfg, tr


class TokenStream:
    """The packed document stream on ``device`` and the steps cut from it."""

    def __init__(self, seed: int, tr: dict, vocab: int, device) -> None:
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        n = int(tr["stream_tokens"])
        gen.manual_seed(seed ^ (DOCS << 40))
        mean = tr["doc_median"] * math.exp(tr["doc_sigma"] ** 2 / 2)
        docs = int(2 * n / mean) + 16
        lengths = torch.exp(math.log(tr["doc_median"]) + tr["doc_sigma"]
                            * torch.randn(docs, generator=gen, device=dev))
        lengths = lengths.round().clamp(tr["doc_min"], tr["doc_max"]).long()
        ends = torch.cumsum(lengths, 0)
        ends = ends[ends < n]
        ranks = torch.arange(1, vocab, dtype=torch.float64, device=dev)
        cdf = torch.cumsum(ranks ** -float(tr["zipf"]), 0)
        gen.manual_seed(seed ^ (TOKENS << 40))
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        rank = torch.searchsorted(cdf / cdf[-1], u).clamp(max=vocab - 2)
        gen.manual_seed(seed ^ (PERM << 40))
        perm = torch.randperm(vocab - 1, generator=gen, device=dev) + 1
        tokens = perm[rank]
        tokens[ends - 1] = 0            # each document closed by the separator
        self.tokens = tokens
        self.b, self.t = int(tr["sequences"]), int(tr["seq_len"])

    @property
    def step_tokens(self) -> int:
        return self.b * self.t

    def batch(self, step: int) -> torch.Tensor:
        """Step ``step``'s (sequences, seq_len + 1) tokens."""
        n = len(self.tokens) - 1
        idx = (step * self.step_tokens
               + torch.arange(self.step_tokens + 1, device=self.tokens.device)) % n
        flat = self.tokens[idx]
        return torch.stack([flat[i * self.t:(i + 1) * self.t + 1]
                            for i in range(self.b)])

    def steps(self, first: int, count: Optional[int] = None,
              deadline: float = float("inf"), fed: Optional[list] = None):
        """Batches of steps ``first``, ``first + 1``, ... until ``count``
        or the first one after ``deadline``; their numbers go to ``fed``."""
        def gen(slot: int):
            s = first
            while ((count is None or s < first + count)
                   and time.perf_counter() < deadline):
                if fed is not None:
                    fed.append(s)
                yield self.batch(s)
                s += 1
        return gen


def weights(seed: int, shapes: Dict[str, tuple], init_range: float, device
            ) -> Dict[str, torch.Tensor]:
    """The benchmark's weights on ``device``: norms 1, every other leaf
    normal(0, ``init_range``), drawn leaf by leaf in name order."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed ^ (LM_WEIGHTS << 40))
    out = {}
    for name in sorted(shapes):
        t = torch.empty(shapes[name], dtype=torch.float32, device=device)
        if "norm" in name:
            t.fill_(1.0)
        else:
            t.normal_(0.0, init_range, generator=gen)
        out[name] = t
    return out


def run(spec) -> dict:
    cfg, tr = sizes(spec)
    ref_mod = spec.cell.reference
    dev = torch.device(spec.device)
    seed = generate.seed_int(spec.seed)
    stream = TokenStream(seed, tr, cfg["vocab_size"], dev)
    steps = int(tr["checked_steps"])
    checked = [stream.batch(s) for s in range(steps)]
    shapes = ref_mod.shapes(cfg)
    out: dict = {"failed": 0}
    if spec.system == "port":
        prog = _port(spec, cfg, tr, seed, stream, checked, shapes, out)
    else:  # the reference in the program's place: control or a fault
        control = spec.system == "control"
        sub = ref_mod.Reference(cfg, dev, rounding="e4m3" if control else None,
                                fault=None if control else spec.system,
                                block=int(tr["ref_block"]))
        prog = _replay(sub, cfg, seed, checked, shapes, dev)
        del sub
        out.update(attempted=steps, window_start=time.perf_counter(),
                   memory_peak_bytes=0)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_mod.Reference(cfg, dev, block=int(tr["ref_block"]))
    out["numbers"] = _check(ref, cfg, seed, checked, shapes, dev, prog)
    out["diag"] = dict(out.get("diag", {}), losses=prog["losses"],
                       ref_losses=out["numbers"].pop("ref_losses"),
                       **out["numbers"].pop("diag"))
    return out


def _replay(ref, cfg, seed, checked, shapes, dev,
            prog: Optional[dict] = None) -> dict:
    """The checked steps by ``ref``: its losses, and step 1's gradients,
    routes and table after the sync (in host memory); compared with
    ``prog``'s, leaf by leaf, where given (the gaps come back instead)."""
    p = weights(seed, shapes, cfg["initializer_range"], dev)
    loss1, grads, routes = ref.loss(p, checked[0], grads=True)
    got: dict = {"losses": [loss1]}
    if prog is None:
        got["grads1"] = {n: g.cpu() for n, g in grads.items()}
        got["routes1"] = [r.cpu() for r in routes]
    else:
        got["grad1_gap"] = _norm_gap(prog["grads1"], grads, dev)
        got["route1_mismatch"] = _mismatch(prog["routes1"], routes)
    tables, gaps, sure, flips = {}, [], [], [0, 0]
    unflipped = []
    for name, w0, change in ref.adamw_first(p, grads, cfg["optimizer"]):
        g, grads[name] = grads[name], None
        if prog is None:
            tables[name] = p[name].cpu()
            continue
        mine = prog["table1"][name].to(dev) - w0
        diff = mine - change
        gaps.append((_gap(diff, change), name))
        flip = torch.sign(mine) != torch.sign(change)
        flips[0] += int(flip.sum())
        flips[1] += flip.numel()
        unflipped.append((_gap(diff[~flip], change[~flip]), name))
        big = g.abs() >= SURE_GRAD * torch.sqrt(torch.mean(g * g))
        big &= g != 0
        if bool(big.any()):
            sure.append((_gap(diff[big], change[big]), name,
                         int((flip & big).sum()), int(big.sum())))
    del grads
    if prog is None:
        got["table1"] = tables
    else:
        got["sync1_gap"] = max(gaps)[0]
        worst = max(sure, default=(0.0, None, 0, 0))
        kept = max(unflipped)
        got["sync1_gap_sure"] = worst[0]
        got["diag"] = {
            "sync1_gap_leaf": max(gaps)[1],
            "sync1_flip_share": flips[0] / max(flips[1], 1),
            "sync1_gap_unflipped": kept[0],
            "sync1_gap_unflipped_leaf": kept[1],
            "sync1_gap_sure_leaf": worst[1],
            "sync1_sure_flips": [worst[2], worst[3]]}
    got["losses"].append(ref.loss(p, checked[1])[0])
    return got


def _gap(diff: torch.Tensor, ref: torch.Tensor) -> float:
    """The norm of ``diff`` over that of ``ref``."""
    return float(torch.linalg.vector_norm(diff)) / max(
        float(torch.linalg.vector_norm(ref)), 1e-30)


def _norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              dev) -> float:
    """The worst leaf's norm of the gap over the larger of the reference
    leaf's norm and the median leaf's."""
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref.items()}
    median = float(np.median(list(norms.values())))
    return max(float(torch.linalg.vector_norm(prog[n].to(dev) - g))
               / max(norms[n], median) for n, g in ref.items())


def _mismatch(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The share of (token, slot) assignments of the reference's top-k
    that the program's top-k of the same token lacks, over every MoE
    layer; a program with fewer slots misses the rest."""
    missed = total = 0
    for p, r in zip(prog, ref):
        p = p.to(r.device)
        hit = (r[:, :, None] == p[:, None, :]).any(-1)
        missed += int((~hit).sum())
        total += r.numel()
    if len(prog) != len(ref):
        return 1.0
    return missed / max(total, 1)


def _check(ref, cfg, seed, checked, shapes, dev, prog) -> Dict[str, float]:
    got = _replay(ref, cfg, seed, checked, shapes, dev, prog=prog)
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], got["losses"]))
    return {"loss_gap": loss, "grad1_gap": got["grad1_gap"],
            "route1_mismatch": got["route1_mismatch"],
            "sync1_gap": got["sync1_gap"],
            "sync1_gap_sure": got["sync1_gap_sure"],
            "ref_losses": got["losses"], "diag": got["diag"]}


def _port(spec, cfg, tr, seed, stream, checked, shapes, out) -> dict:
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.config import FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.models.deepseek_v2 import (
        AdamWConfig, DeepseekV2Config, LMTrainer, param_shapes)
    dev = torch.device(spec.device)
    cuda = dev.type == "cuda"
    mcfg = DeepseekV2Config.from_dict(
        cfg, compute_dtype=torch.bfloat16 if cuda else torch.float32)
    if param_shapes(mcfg) != shapes:
        raise ValueError("the port's parameters differ from the reference's")
    mvt.init(device=spec.device, local_workers=int(tr["workers"]), sync=False)
    prog: dict = {"losses": []}
    trainer = None
    try:
        w0 = {n: t.cpu() for n, t in weights(
            seed, shapes, cfg["initializer_range"], dev).items()}
        trainer = LMTrainer(mcfg, w0, AdamWConfig(**cfg["optimizer"]),
                            workers=int(tr["workers"]),
                            sync_freq=int(tr["sync_freq"]))
        del w0
        losses: List[torch.Tensor] = []

        def on_loss(slot, loss):
            losses.append(loss)

        # step 1 alone: its gradients and routing read back, then the table
        grads1, routes1 = {}, {}
        # copies: the step clips its gradients in place after the hook
        trainer.grad_hook = lambda names, gs: grads1.update(
            (n, g.to("cpu", copy=True)) for n, g in zip(names, gs))
        trainer.route_hook = lambda layer, ids: routes1.__setitem__(
            layer, ids.to("cpu", copy=True))
        trainer.train(stream.steps(0, 1), on_loss)
        trainer.grad_hook = trainer.route_hook = None
        prog["grads1"] = grads1
        prog["routes1"] = [routes1[k] for k in sorted(routes1)]
        prog["table1"] = {n: t.cpu() for n, t in
                          trainer.asgd.global_params().items()}
        trainer.train(stream.steps(1, len(checked) - 1), on_loss)
        prog["losses"] = [float(x) for x in losses]
        out["attempted"] = len(checked)
        if spec.window:
            trainer.train(stream.steps(len(checked), int(tr["warmup_steps"])))
            first = len(checked) + int(tr["warmup_steps"])
            Dashboard.reset()
            if cuda:
                torch.cuda.synchronize()
            fed: List[int] = []
            t0 = time.perf_counter()
            out["window_start"] = t0
            trainer.train(stream.steps(first, deadline=t0 + spec.seconds,
                                       fed=fed))
            if cuda:
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
            tokens = len(fed) * stream.step_tokens
            out["attempted"] += len(fed)
            out["e2e"] = {"train_tokens_per_s": tokens / window}
            step_flops = counts_lm.step_flops(cfg, stream.b, stream.t)
            out["ctx"] = {"window_s": window, "tokens": tokens,
                          "steps": len(fed), "flops": step_flops * len(fed),
                          "snapshot": Dashboard.snapshot()}
            if spec.trace:
                sub: List[int] = []
                out["trace"] = devtrace.profiled(lambda: trainer.train(
                    stream.steps(first + len(fed), deadline=time.perf_counter()
                                 + float(tr["trace_seconds"]), fed=sub)))
                out["ctx"]["trace"] = dict(
                    out["trace"], work_flops=step_flops * len(sub),
                    work_bytes=counts_lm.step_bytes(cfg) * len(sub))
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if cuda else 0)
    finally:
        trainer = None
        mvt.shutdown()
        FLAGS.reset()
    return prog
