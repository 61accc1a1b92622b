"""word2vec trained from a zipf corpus (kind ``word2vec``), on the PS
trainer (``trainer: ps``: ``PSTrainer.train``, pipelined, ``group``
blocks a submission) or the single-device trainer (``trainer: device``:
``DeviceTrainer.train``, a block of ``group`` blocks a step).

Set-up builds the trainer, installs the benchmark's initial weights, and
drives it through its first ``checked_steps`` steps by the window's own
call, ``train``, over the window's stream: the first step alone, then the
rest in one call, pipelined as in the window, with the benchmark's draws
through the trainer's ``draw_hook``. It records each step's loss and its
tables' changes after the first step and after the last. The window then
trains the same trainer on the rest of the corpus, with the port's own
device draws, until ``seconds`` have passed. After the window the
reference follows those first steps from the same inputs, and the check
compares each step's loss, each leaf's change after the first step and
after the last, and the widest gap of a row's change.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import counts as counts_mod
import devtrace
import generate
import hostprobe


class Stream:
    """The corpus as ``block_tokens`` blocks from block ``first`` on, cycled,
    ``group`` blocks joined into one where ``joined``, and stopped at the
    first whole group after ``deadline`` or after ``groups`` groups.
    Records what it handed out."""

    def __init__(self, corpus: np.ndarray, block: int, group: int,
                 first: int, deadline: float, joined: bool,
                 groups: Optional[int] = None) -> None:
        self.corpus, self.block, self.group = corpus, block, group
        self.nblk = len(corpus) // block
        self.next, self.deadline, self.joined = first, deadline, joined
        self.groups = groups
        self.fed: List[np.ndarray] = []  # one entry a group
        self.times: List[float] = []  # host clock as each group is handed out

    def __call__(self):
        while (time.perf_counter() < self.deadline
               and (self.groups is None or len(self.fed) < self.groups)):
            start = (self.next % self.nblk) * self.block
            unit = self.corpus[start:start + self.block * self.group]
            self.next += self.group
            self.fed.append(unit)
            self.times.append(time.perf_counter())
            if self.joined:
                yield unit
            else:
                yield from np.split(unit, self.group)

    @property
    def tokens(self) -> int:
        return sum(len(u) for u in self.fed)


def _leaf_changes(cur: torch.Tensor, base, rows: int = 1 << 18):
    """(float64 norm of ``cur - base``, the ids of the rows that changed,
    their float64 changes); ``base`` None is zeros."""
    total, ids, deltas = 0.0, [], []
    for lo in range(0, cur.shape[0], rows):
        d = cur[lo:lo + rows].double()
        if base is not None:
            d = d - base[lo:lo + rows].double()
        total += float((d * d).sum())
        hit = torch.nonzero(d.abs().sum(dim=1) > 0).reshape(-1)
        ids.append(hit + lo)
        deltas.append(d[hit])
    return total ** 0.5, torch.cat(ids), torch.cat(deltas)


class PortTrainer:
    """The port's trainer, with its tables read as plain tensors."""

    def __init__(self, kind: str, wcfg, dictionary, device: str, w0) -> None:
        import multiverso_tpu_torch as mvt
        from multiverso_tpu_torch.models.word2vec import (DeviceTrainer,
                                                          PSTrainer)
        self.kind, self.mvt = kind, mvt
        v, d = w0.shape
        self.v, self.d = v, d
        if kind == "ps":
            mvt.init(device=device, local_workers=1, sync=False)
            self.t = PSTrainer(wcfg, dictionary)
            # the initial weights go in as one transaction on the dispatcher
            self._tables(lambda w_in, w_out: w_in.copy_(w0))
        else:
            self.t = DeviceTrainer(wcfg, dictionary, device=device)
            self.t.params["w_in"][:v].copy_(w0)

    def _tables(self, fn):
        """``fn(w_in, w_out)`` over the live tables' logical parts."""
        if self.kind == "device":
            p = self.t.params
            return fn(p["w_in"][:self.v, :self.d], p["w_out"][:self.v, :self.d])

        def txn(datas, states):
            extra = fn(datas[0][:self.v, :self.d], datas[1][:self.v, :self.d])
            return datas, states, extra

        tin = self.t.input_table
        return tin.wait(tin.transact_device_async(txn, [self.t.output_table]))

    def changes(self, w0, rows_too: bool):
        def read(w_in, w_out):
            a = _leaf_changes(w_in, w0)
            b = _leaf_changes(w_out, None)
            return [a, b] if rows_too else [a[0], b[0]]
        return self._tables(read)

    def close(self) -> None:
        if self.kind == "ps":
            from multiverso_tpu_torch.config import FLAGS
            self.mvt.shutdown()
            FLAGS.reset()
        self.t = None


def _gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers, each the worst over steps or leaves."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))

    def norm_gap(p_norms, r_norms):
        median = float(np.median(r_norms))
        return max(abs(p - r) / max(r, median) for p, r in zip(p_norms, r_norms))

    ref3 = [float(torch.linalg.vector_norm(d)) for d in ref["delta"]]
    row = 0.0
    for (_, ids, rows), dref in zip(prog["rows3"], ref["delta"]):
        rnorm = torch.linalg.vector_norm(dref, dim=1)
        union = torch.unique(torch.cat([ids, torch.nonzero(rnorm > 0).reshape(-1)]))
        got = torch.zeros((len(union), dref.shape[1]), dtype=dref.dtype,
                          device=dref.device)
        got[torch.searchsorted(union, ids)] = rows.to(dref.dtype)
        want = dref[union]
        scale = torch.clamp(rnorm[union], min=float(rnorm[rnorm > 0].median()))
        row = max(row, float((torch.linalg.vector_norm(got - want, dim=1)
                              / scale).max()))
    return {"loss_gap": loss,
            "grad1_gap": norm_gap(prog["norms1"], ref["norms1"]),
            "change3_gap": norm_gap([r[0] for r in prog["rows3"]], ref3),
            "change3_rowgap": row}


def run(spec) -> dict:
    cfg, tr, ref_mod = spec.cell.config, spec.cell.traffic, spec.cell.reference
    V, D = cfg["vocab_size"], cfg["dim"]
    dev = torch.device(spec.device)
    seed = generate.seed_int(spec.seed)
    counts = generate.zipf_counts(V)
    block, group, steps = tr["stream_block"], tr["group"], tr["checked_steps"]
    unit = block * group
    corpus = generate.corpus(seed, tr["corpus_groups"] * unit, counts, dev)
    checked = [corpus[s * unit:(s + 1) * unit] for s in range(steps)]
    kind = tr["trainer"]
    draws = generate.ChunkDraws(seed, cfg["window"], cfg["negatives"],
                                None if kind == "ps" else
                                generate.unigram_cdf(counts))
    w0 = generate.uniform_weights(seed, V, D, -0.5 / D, 0.5 / D, dev)
    out: dict = {"failed": 0}
    if spec.system == "port":
        prog = _port(spec, cfg, tr, kind, seed, counts, corpus, checked,
                     draws, w0, out)
    else:  # the reference put in the program's place: control or fault
        sub = ref_mod.Reference(cfg, counts, dev, dtype=torch.float32,
                                tf32=spec.system == "control",
                                half=spec.system == "half")
        got = sub.replay(w0, checked, kind, np.random.default_rng(seed),
                         draws.hook, _lrs(cfg, tr, ref_mod, steps))
        prog = {"losses": got["losses"], "norms1": got["norms1"],
                "rows3": [_leaf_changes(d, None) for d in got["delta"]]}
        del got, sub
        out.update(attempted=steps, window_start=time.perf_counter(),
                   memory_peak_bytes=0)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_mod.Reference(cfg, counts, dev).replay(
        w0, checked, kind, np.random.default_rng(seed), draws.hook,
        _lrs(cfg, tr, ref_mod, steps))
    out["numbers"] = _gaps(prog, ref)
    out["diag"] = {"losses": prog["losses"], "ref_losses": ref["losses"],
                   "norms1": prog["norms1"], "ref_norms1": ref["norms1"]}
    for key in ("host", "groups_ms"):
        if key in out:
            out["diag"][key] = out.pop(key)
    return out


def _port(spec, cfg, tr, kind, seed, counts, corpus, checked, draws, w0,
          out) -> Dict:
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.models.vocab import Dictionary
    from multiverso_tpu_torch.models.word2vec import Word2VecConfig
    wcfg = Word2VecConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["dim"], window=cfg["window"],
        negatives=cfg["negatives"], lr=cfg["lr"], sample=cfg["sample"],
        batch_pairs=cfg["batch_pairs"], block_tokens=cfg["block_tokens"],
        neg_sharing=cfg["neg_sharing"], max_row_step=cfg["max_row_step"],
        seed=seed)
    dictionary = Dictionary()
    dictionary.counts = counts
    trainer = PortTrainer(kind, wcfg, dictionary, spec.device, w0)
    group = tr["group"]
    steps = len(checked)
    prog: Dict = {"losses": []}
    train_kw = dict(log_every_s=1e9, total_words=int(tr["planned_tokens"]))
    if kind == "ps":
        train_kw["group"] = group
    joined = kind == "device"
    try:
        # the checked steps: the window's call over the window's stream,
        # the first step alone (its change is read), then the rest
        _record_losses(trainer.t, prog["losses"])
        trainer.t.draw_hook = draws.sequential_hook()
        trainer.t.train(Stream(corpus, tr["stream_block"], group, 0,
                               float("inf"), joined, groups=1), **train_kw)
        prog["norms1"] = trainer.changes(w0, rows_too=False)
        trainer.t.train(Stream(corpus, tr["stream_block"], group, group,
                               float("inf"), joined, groups=steps - 1),
                        **train_kw)
        prog["rows3"] = trainer.changes(w0, rows_too=True)
        trainer.t.draw_hook = None
        for name in ("finish_block", "train_block"):
            trainer.t.__dict__.pop(name, None)
        out["attempted"] = steps
        if spec.window:
            # the window's own loop for a few groups more: the checked steps
            # warmed every shape; these reach the pipeline's steady overlap
            warm = Stream(corpus, tr["stream_block"], group, steps * group,
                          float("inf"), joined=joined,
                          groups=int(tr["warmup_groups"]))
            trainer.t.train(warm, **train_kw)
            Dashboard.reset()
            if spec.device == "cuda":
                torch.cuda.synchronize()
            stream = Stream(corpus, tr["stream_block"], group, warm.next,
                            time.perf_counter() + spec.seconds,
                            joined=joined)
            probe = hostprobe.Probe()
            t0 = time.perf_counter()
            out["window_start"] = t0
            trainer.t.train(stream, **train_kw)
            window = time.perf_counter() - t0
            txn = Dashboard.get("SERVER_PROCESS_TRANSACT")
            out["attempted"] += len(stream.fed)
            out["e2e"] = {"train_tokens_per_s": stream.tokens / window}
            out["host"] = probe.stop()
            out["groups_ms"] = [round(1e3 * (b - a), 1) for a, b in
                                zip(stream.times, stream.times[1:])]
            keep = spec.cell.reference.keep_probs(counts, cfg["sample"])
            out["ctx"] = {
                "window_s": window, "tokens": stream.tokens,
                "submissions": len(stream.fed),
                "txn": (txn.count, txn.elapse_ms),
                "flops": _flops(cfg, keep, stream.fed)}
            if spec.trace:
                _label(trainer.t)
                subs: List[Stream] = []

                def traced():
                    subs.append(Stream(
                        corpus, tr["stream_block"], group, stream.next,
                        time.perf_counter() + float(tr["trace_seconds"]),
                        joined=joined))
                    trainer.t.train(subs[0], **train_kw)

                out["trace"] = devtrace.profiled(traced)
                out["ctx"]["trace"] = dict(
                    out["trace"], work_flops=_flops(cfg, keep, subs[0].fed),
                    work_bytes=counts_mod.sgns_bytes(subs[0].fed, cfg["dim"]))
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if spec.device == "cuda" else 0)
    finally:
        trainer.close()
        del trainer
    return prog


def _record_losses(trainer, losses: List[float]) -> None:
    """Keep each checked step's loss as the trainer computes it: the PS
    trainer's ``finish_block`` made to fetch it (in ``train`` it skips
    the read-back until the last step), the device trainer's
    ``train_block`` return. Set on the instance; popping them restores
    the class's methods."""
    name = "finish_block" if hasattr(trainer, "finish_block") else "train_block"
    fn = getattr(trainer, name)

    if name == "finish_block":
        def wrapped(pend, fetch_stats=True):
            losses.append(float(fn(pend, fetch_stats=True)))
            return losses[-1]
    else:
        def wrapped(block, lr=None):
            losses.append(float(fn(block, lr)))
            return losses[-1]

    setattr(trainer, name, wrapped)


def _lrs(cfg, tr, ref_mod, steps: int) -> List[float]:
    """Each checked step's learning rate: ``train``'s linear decay over the
    planned tokens, from 0 at the start of each call (the first step
    alone, then the rest)."""
    unit = tr["stream_block"] * tr["group"]
    seen = [0] + [k * unit for k in range(steps - 1)]
    return [ref_mod.decayed_lr(cfg["lr"], n, int(tr["planned_tokens"]))
            for n in seen]


def _flops(cfg, keep: np.ndarray, fed: List[np.ndarray]) -> float:
    kept = sum(counts_mod.kept_tokens(u, keep) for u in fed)
    return counts_mod.sgns_flops(kept, cfg["window"], cfg["negatives"],
                                 cfg["dim"], cfg["block_tokens"])


def _label(trainer) -> None:
    """Name the trainer's calls in the profile (``bench.<method>``)."""
    for name in ("submit_block", "finish_block", "train_block"):
        fn = getattr(trainer, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _name=f"bench.{name}", **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        setattr(trainer, name, wrapped)
