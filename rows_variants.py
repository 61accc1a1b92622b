#!/usr/bin/env python3
"""Time the row gather and row scatter, their design variants and,
optionally, an earlier checkout's kernels, on one CUDA card.

    python3 rows_variants.py                      # from the root of a checkout
    python3 rows_variants.py --parent DIR         # also DIR's csrc/rows.cu

Builds ``multiverso_tpu_torch/csrc/rows.cu`` (the shipped kernels), each
variant of ``csrc/rows_variants.cu`` (one ``nvcc`` each, all started
together; a variant that does not build is reported, not fatal) and, with
``--parent``, the ``csrc/rows.cu`` of that checkout, whose gather and
scatter take the 7-argument interface of the first port slices. The
shipped scatter is timed as the wrapper launches it and with each of its
two paths forced. Every kernel but the probes is first held bit for bit
against ``index_select`` / ``index_add_`` on each shape's first id set; one
that differs is reported and not timed. Then CUDA-event times, each kernel
in turns (forward, then backward), at:

* ``ps``: 1024 unique random ids into the PS table (1M + 1 x 52 fp32),
  1024 rotating id sets (1024 x 1024 x 208 B = 218 MB, over 4x the L2);
* ``ps_256_sets``: the same with 256 of the sets (54 MB, about the L2),
  as the first port slices timed it;
* ``ps_sorted``: the 1024 sets, each sorted; ``ps_2mb``: 1024 sets of ids
  below 10,000 (2 MB of rows, which stay in L2); ``ps_one_set``: one set
  over and over (its rows stay in L2, spread over the whole table);
* ``ps64``: 64 ids a set;
* ``w2v_push`` / ``w2v_pull``: 65,536-slot buckets of the sorted unique
  zipf tokens of a group-64 word2vec submission, into / from
  100,001 x 128 fp32;

beside the launch floor (``fill_`` on a one-element tensor), the library
call and the bytes bound; the wrappers' host time and its pieces (with
``--parent``, also each tree's wrappers in fresh processes, in turns);
the gather at the 64-slot bucket through its wrapper and directly; a sweep of the shipped kernels' block shape;
and the scatter's two paths across batch sizes (where one overtakes the
other). Prints one JSON line per result (and writes all of them to
``--out FILE`` when given). Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import HBM_BYTES_PER_S, device_ms

REPO = Path(__file__).resolve().parent
CSRC = REPO / "multiverso_tpu_torch" / "csrc"
VARIANTS = {  # name -> (kernel kind, -D macro, block: the shipped block
    # whose path the variant reworks; the TMA variants take one pass)
    "gather_shfl": ("gather", "MVT_V_GATHER_SHFL", "gather"),
    "gather_inflight": ("gather", "MVT_V_GATHER_INFLIGHT", "gather"),
    "gather_cs": ("gather", "MVT_V_GATHER_CS", "gather"),
    "gather_tma": ("gather", "MVT_V_GATHER_TMA", "gather_one_pass"),
    "gather_pagewarm": ("gather", "MVT_V_GATHER_PAGEWARM", "gather"),
    "scatter_red1": ("scatter", "MVT_V_SCATTER_RED1", "l2"),
    "scatter_l2_pagewarm": ("scatter", "MVT_V_SCATTER_L2_PAGEWARM", "l2"),
    "scatter_sm_cs": ("scatter", "MVT_V_SCATTER_SM_CS", "sm"),
    "scatter_tma_rmw": ("scatter", "MVT_V_SCATTER_TMA_RMW", "sm_one_pass"),
    "scatter_tma_red": ("scatter", "MVT_V_SCATTER_TMA_RED", "l2_one_pass"),
    # probes of the gather's chain: timed, never held to index_select
    "probe_store": ("probe", "MVT_V_PROBE_STORE", "gather"),
    "probe_id": ("probe", "MVT_V_PROBE_ID", "gather"),
    "probe_row": ("probe", "MVT_V_PROBE_ROW", "gather"),
}
_P, _I = ctypes.c_void_p, ctypes.c_int64
ONE_PASS_WAVES = 1 << 20


def build_all(out_dir: Path, parent: Path | None):
    """Start one nvcc per library, all together; returns {name: (CDLL or
    None, log)}."""
    from multiverso_tpu_torch.ops import kernels
    nvcc = kernels.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: (CSRC / "rows_variants.cu", [f"-D{macro}"])
               for name, (_, macro, _) in VARIANTS.items()}
    if parent is not None:
        sources["parent"] = (parent / "multiverso_tpu_torch" / "csrc" / "rows.cu", [])
    t0 = time.perf_counter()
    jobs = {}
    for name, (src, defines) in sources.items():
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *defines, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {"shipped": (kernels.load("rows"), kernels.build_logs.get("rows", ""))}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        built[name] = (ctypes.CDLL(str(lib)) if proc.returncode == 0 else None, log)
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return built


def ptxas_lines(log: str):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "error" in line]


def kernels_to_time(built):
    """name -> (kind, launch(table, ids, other, geometry), block), where
    block names the launch geometry (``geometry``)."""
    def vecs_of(table):
        return table.shape[1] * table.element_size() // 16

    def new_style(fn, in_l2=None):
        """The shipped interface, with the scatter's ``in_l2`` if given."""
        fn.argtypes = ([_P, _P, _P, _I, _I, _I, _I, _I, _I]
                       + ([_I] if in_l2 is not None else []) + [_P])
        fn.restype = ctypes.c_int

        def launch(table, ids, other, g):
            extra = () if in_l2 is None else (int(in_l2(ids.shape[0], vecs_of(table))),)
            return fn(table.data_ptr(), ids.data_ptr(), other.data_ptr(), table.shape[0],
                      ids.shape[0], vecs_of(table), *g, *extra,
                      torch.cuda.current_stream().cuda_stream)
        return launch

    def old_style(fn):
        fn.argtypes, fn.restype = [_P, _P, _P, _I, _I, _I, _P], ctypes.c_int

        def launch(table, ids, other, g):
            return fn(table.data_ptr(), ids.data_ptr(), other.data_ptr(), table.shape[0],
                      ids.shape[0], vecs_of(table), torch.cuda.current_stream().cuda_stream)
        return launch

    from multiverso_tpu_torch.ops import rows
    lib = built["shipped"][0]
    scatter = lib.mvt_scatter_add_rows_f32
    out = {"gather": ("gather", new_style(lib.mvt_gather_rows), "gather"),
           "scatter": ("scatter", new_style(
               scatter, lambda b, v: rows.scatter_launch(b, v, 1)[1]), "scatter"),
           "scatter_in_l2": ("scatter", new_style(scatter, lambda b, v: 1), "l2"),
           "scatter_through_sm": ("scatter", new_style(scatter, lambda b, v: 0), "sm"),
           "coalesced": ("scatter", old_style(lib.mvt_scatter_add_rows_coalesced_f32), "sm")}
    if built.get("parent", (None,))[0] is not None:
        p = built["parent"][0]
        out["parent_gather"] = ("gather", old_style(p.mvt_gather_rows), "gather")
        out["parent_scatter"] = ("scatter", old_style(p.mvt_scatter_add_rows_f32), "sm")
    for name, (kind, _, block) in VARIANTS.items():
        if built[name][0] is not None:
            out[name] = (kind, new_style(built[name][0].mvt_variant), block)
    return out


def geometry(block, B, vecs, sm, threads=None, lanes=None, waves=None):
    """The shipped launch geometry of ``block`` ("gather"; "scatter", the
    path the wrapper picks; "l2" or "sm", one path; "..._one_pass": with a
    grid that covers the batch), or a swept one."""
    from multiverso_tpu_torch.ops import rows
    one_pass = block.endswith("_one_pass")
    block = block.removesuffix("_one_pass")
    if block == "scatter":
        block = "l2" if rows.scatter_launch(B, vecs, sm)[1] else "sm"
    threads_lanes = {"gather": rows.GATHER_BLOCK, "l2": rows.SCATTER_BLOCK_L2,
                     "sm": rows.SCATTER_BLOCK_SM}[block]
    return rows.launch_geometry(B, vecs, sm, threads or threads_lanes[0],
                                lanes or threads_lanes[1],
                                ONE_PASS_WAVES if one_pass else waves or rows.WAVES)


def shapes(dev, rng):
    """name -> (table, [id sets], mean live slots a set, the slot from which
    deltas are zero: no set's pads then carry a nonzero delta)."""
    R, C = chip_smoke.ROWS + 1, 52
    ps_table = torch.from_numpy(rng.standard_normal((R, C)).astype(np.float32)).to(dev)
    ps = [rng.choice(chip_smoke.ROWS, chip_smoke.BATCH, replace=False).astype(np.int32)
          for _ in range(1024)]
    near = [rng.choice(10_000, chip_smoke.BATCH, replace=False).astype(np.int32)
            for _ in range(1024)]
    ps64 = [rng.choice(chip_smoke.ROWS, 64, replace=False).astype(np.int32)
            for _ in range(1024)]
    V, D = chip_smoke.W2V["vocab_size"], chip_smoke.W2V["dim"]
    sets, lives = [], []
    for _ in range(4):
        u = np.unique(chip_smoke.zipf_tokens(
            rng, chip_smoke.W2V_GROUP * chip_smoke.W2V["block_tokens"], V))
        sets.append(u)
        lives.append(len(u))
    B = max(64, 1 << int(max(lives)).bit_length())
    w2v = [np.concatenate([u, np.full(B - len(u), V, np.int32)]).astype(np.int32)
           for u in sets]
    w2v_table = torch.from_numpy(rng.standard_normal((V + 1, D)).astype(np.float32)).to(dev)

    def up(sets_):
        return [torch.from_numpy(s).to(dev) for s in sets_]

    B_ps = chip_smoke.BATCH
    w2v_args = (w2v_table, up(w2v), int(np.mean(lives)), min(lives))
    return {"ps": (ps_table, up(ps), B_ps, B_ps),
            "ps_256_sets": (ps_table, up(ps[:256]), B_ps, B_ps),
            "ps_sorted": (ps_table, up([np.sort(s) for s in ps]), B_ps, B_ps),
            "ps_2mb": (ps_table, up(near), B_ps, B_ps),
            "ps_one_set": (ps_table, up(ps[:1]), B_ps, B_ps),
            "ps64": (ps_table, up(ps64), 64, 64),
            "w2v_push": w2v_args, "w2v_pull": w2v_args}


def bound_ms(kind, B, n_live, row_bytes):
    """Each input byte read once, each output byte written once: ids, the
    live rows (and the sentinel) read, for the scatter the deltas read and
    the rows written, for the gather the output written."""
    rows_moved = n_live + (1 if n_live < B else 0)
    if kind == "scatter":
        b = 4 * B + B * row_bytes + 2 * rows_moved * row_bytes
    else:
        b = 4 * B + rows_moved * row_bytes + B * row_bytes
    return b / HBM_BYTES_PER_S * 1e3


def special_values(ks, sm, dev, rng, emit):
    """Every scatter on float32 values where an add could round or flush
    differently (signed zeros, subnormals, the largest normals,
    infinities), held to index_add_ bit for bit."""
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                        -1.1754942e-38, 1.0, -1.0, 3.4e38, -3.4e38, np.inf, -np.inf],
                       np.float32)
    table = torch.from_numpy(rng.choice(special, (256, 52))).to(dev)
    ids = torch.from_numpy(rng.choice(256, 64, replace=False).astype(np.int32)).to(dev)
    deltas = torch.from_numpy(rng.choice(special[:-2], (64, 52))).to(dev)
    want = table.clone().index_add_(0, ids, deltas).view(torch.int32)
    for k, (kind, launch, block) in ks.items():
        if kind != "scatter":
            continue
        got = table.clone()
        code = launch(got, ids, deltas, geometry(block, 64, 13, sm))
        torch.cuda.synchronize()
        emit({"special_values": k, "error": code,
              "bitwise_equal_to_index_add_": bool(torch.equal(got.view(torch.int32), want)),
              "bits_differing": int((got.view(torch.int32) != want).sum())})


def crossover(ks, sm, dev, rng, iters, emit, card):
    """The scatter's two paths, in turns, across batch sizes at the PS row
    (13 vectors) and the word2vec row (32): where adding in L2 stops
    paying."""
    for rows_n, cols in ((chip_smoke.ROWS + 1, 52), (chip_smoke.W2V["vocab_size"] + 1, 128)):
        table = torch.zeros((rows_n, cols), device=dev)
        for B in (256, 1024, 2048, 4096, 8192, 16384, 32768, 65536):
            sets = [torch.from_numpy(rng.choice(rows_n - 1, B, replace=False)
                                     .astype(np.int32)).to(dev)
                    for _ in range(8 if B > 4096 else 64)]
            deltas = torch.ones((B, cols), device=dev)
            it = iter(range(1 << 62))
            times, geoms = {}, {}
            for k in ("scatter_in_l2", "scatter_through_sm", "scatter_through_sm",
                      "scatter_in_l2"):
                _, launch, block = ks[k]
                g = geoms[k] = geometry(block, B, cols // 4, sm)
                times.setdefault(k, []).append(device_ms(
                    lambda: launch(table, sets[next(it) % len(sets)], deltas, g), iters))
            emit({"crossover": {"batch": B, "vecs": cols // 4, "pairs": B * cols // 4},
                  "geometry": {k: list(g) for k, g in geoms.items()}, "ms": times,
                  "card": card})
        del table


def host_costs(dev, iters: int = 2000):
    """Host µs per call of each wrapper at the PS shape and of the pieces
    of its card path (best of three loops of ``iters`` calls; the
    kernels queue behind)."""
    from multiverso_tpu_torch.ops import rows
    table = torch.zeros((chip_smoke.ROWS + 1, 52), device=dev)
    ids = torch.arange(chip_smoke.BATCH, dtype=torch.int32, device=dev)
    deltas = torch.zeros((chip_smoke.BATCH, 52), device=dev)
    pieces = {
        "scatter_add_rows": lambda: rows.scatter_add_rows(table, ids, deltas),
        "gather_rows": lambda: rows.gather_rows(table, ids),
        "check_scatter": lambda: rows._check_scatter("op", table, ids, deltas),
        "kernel_args": lambda: rows._kernel_args("op", ids, table, deltas),
        "scatter_launch": lambda: rows.scatter_launch(chip_smoke.BATCH, 13, 132),
        "data_ptr_x3": lambda: (table.data_ptr(), ids.data_ptr(), deltas.data_ptr()),
        "table_device": lambda: table.device,
        "torch.cuda.current_device": torch.cuda.current_device,
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.empty_1024x52": lambda: torch.empty((chip_smoke.BATCH, 52), device=dev),
    }
    out = {}
    for name, fn in pieces.items():
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) / iters * 1e6)
        out[name] = best
    torch.cuda.synchronize()
    return out


HOST_AB = r"""
import json, sys, time, torch
from multiverso_tpu_torch.ops import rows
dev = torch.device("cuda", 0)
table = torch.zeros((1_000_001, 52), device=dev)
ids = torch.arange(1024, dtype=torch.int32, device=dev)
deltas = torch.zeros((1024, 52), device=dev)
out = {}
for name, fn in (("scatter_add_rows", lambda: rows.scatter_add_rows(table, ids, deltas)),
                 ("gather_rows", lambda: rows.gather_rows(table, ids))):
    fn()
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        best = min(best, (time.perf_counter() - t0) / 2000 * 1e6)
    out[name] = best
print(json.dumps(out))
"""


def host_ab(parent: Path):
    """Each wrapper's host µs per call at the PS shape (best of five loops
    of 2000 calls) in a fresh process from the parent checkout and from
    this one, in turns: parent, change, change, parent."""
    runs = []
    for where in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, "-c", HOST_AB], cwd=where, check=True,
                              capture_output=True, text=True)
        runs.append({"tree": "parent" if where == parent else "change",
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
    return runs


def bucket64_paths(ks, sm, dev, rng, iters):
    """The shipped gather at the 64-slot bucket (1024 sets of 64 ids into
    1M + 1 x 52 fp32), through its wrapper and through the C call, on a
    zero table and on a random one, after 400 scatters into the same
    table: where a wrapper timing and a direct one can part."""
    from multiverso_tpu_torch.ops import rows
    sets = [torch.from_numpy(rng.choice(chip_smoke.ROWS, 64, replace=False)
                             .astype(np.int32)).to(dev) for _ in range(1024)]
    deltas = torch.from_numpy(rng.standard_normal((64, 52)).astype(np.float32)).to(dev)
    out_buf = torch.empty((64, 52), device=dev)
    launch = ks["gather"][1]
    g = geometry("gather", 64, 13, sm)
    it = iter(range(1 << 62))

    def ids():
        return sets[next(it) % len(sets)]

    times = {}
    for fill in ("zeros", "random"):
        table = (torch.zeros((chip_smoke.ROWS + 1, 52), device=dev) if fill == "zeros" else
                 torch.from_numpy(rng.standard_normal((chip_smoke.ROWS + 1, 52))
                                  .astype(np.float32)).to(dev))
        device_ms(lambda: rows.scatter_add_rows(table, ids(), deltas), iters)
        for path in ("wrapper", "direct", "direct", "wrapper"):
            fn = ((lambda: rows.gather_rows(table, ids())) if path == "wrapper"
                  else (lambda: launch(table, ids(), out_buf, g)))
            times.setdefault(f"{fill}_{path}", []).append(device_ms(fn, iters))
        del table
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose csrc/rows.cu is timed beside")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write every result, as one JSON list, here")
    parser.add_argument("--iters", type=int, default=400)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("rows_variants: torch finds no CUDA device", file=sys.stderr)
        return 1

    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    built = build_all(REPO / "multiverso_tpu_torch" / "_build" / "variants", args.parent)
    results = [{"card": card, "sms": sm}]

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)

    for name, (cdll, log) in built.items():
        emit({"build": name, "ok": cdll is not None, "ptxas": ptxas_lines(log)})
    ks = kernels_to_time(built)
    rng = np.random.default_rng(11)
    emit({"launch_floor_ms": chip_smoke.launch_floor_ms(dev, args.iters), "card": card})
    emit({"host_us": host_costs(dev), "card": card})
    if args.parent is not None:
        emit({"host_us_parent_against_change": host_ab(args.parent), "card": card})
    emit({"gather_64_slot_paths_ms": bucket64_paths(ks, sm, dev, rng, args.iters),
          "card": card})
    special_values(ks, sm, dev, rng, emit)

    for shape, (table, id_sets, n_live, pads) in shapes(dev, rng).items():
        kinds = {"w2v_push": ("scatter",), "w2v_pull": ("gather",)}.get(
            shape, ("scatter", "gather"))
        B, vecs = id_sets[0].shape[0], table.shape[1] * 4 // 16
        row_bytes = table.shape[1] * 4
        deltas = torch.from_numpy(
            rng.standard_normal((B, table.shape[1])).astype(np.float32)).to(dev)
        deltas[pads:] = 0  # sentinel pads carry zero deltas
        it = iter(range(1 << 62))

        def ids():
            return id_sets[next(it) % len(id_sets)]

        for kind in kinds:
            names = [k for k, v in ks.items()
                     if v[0] == kind or (kind == "gather" and v[0] == "probe")]
            ok = {}
            for k in names:  # bit for bit against the library call
                kk, launch, block = ks[k]
                if kk == "probe":
                    ok[k] = True
                    continue
                g = geometry(block, B, vecs, sm)
                if kind == "gather":
                    got = torch.empty((B, table.shape[1]), device=dev)
                    code = launch(table, id_sets[0], got, g)
                    want = table.index_select(0, id_sets[0])
                else:
                    got = table.clone()
                    code = launch(got, id_sets[0], deltas, g)
                    want = table.clone().index_add_(0, id_sets[0], deltas)
                torch.cuda.synchronize()
                ok[k] = code == 0 and torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32))
                if not ok[k]:
                    emit({"shape": shape, "kernel": k, "error": code, "equal": False,
                          "max_abs_err": float((got - want).abs().max()) if code == 0 else None})
                del got, want
            lib = ((lambda: table.index_add_(0, ids(), deltas)) if kind == "scatter"
                   else (lambda: table.index_select(0, ids())))
            timed = [k for k in names if ok[k]]
            times = {k: [] for k in timed + ["library"]}
            out = torch.empty((B, table.shape[1]), device=dev)
            other = out if kind == "gather" else deltas
            for order in (timed + ["library"], list(reversed(timed)) + ["library"]):
                for k in order:
                    if k == "library":
                        times[k].append(device_ms(lib, args.iters))
                        continue
                    kk, launch, block = ks[k]
                    g = geometry(block, B, vecs, sm)
                    times[k].append(device_ms(lambda: launch(table, ids(), other, g),
                                              args.iters))
            emit({"shape": shape, "kind": kind, "bucket": B, "live": n_live,
                  "bound_ms": bound_ms(kind, B, n_live, row_bytes),
                  "ms": times, "card": card})
            # the shipped kernel's block shape and grid cap, swept
            _, launch, block = ks[kind]
            sweep = []
            for threads in (64, 128, 256):
                for lanes in (8, 16, 32):
                    for waves in (8, 16, 32, ONE_PASS_WAVES):
                        for fill in (True, False):  # a block for every SM, or not
                            g = geometry(block, B, vecs, sm if fill else 1, threads=threads,
                                         lanes=lanes, waves=waves * (1 if fill else sm))
                            if any(s["geometry"] == list(g) for s in sweep):
                                continue
                            sweep.append({"threads": threads, "lanes": lanes, "waves": waves,
                                          "fill": fill, "geometry": list(g),
                                          "ms": device_ms(lambda: launch(table, ids(), other, g),
                                                          args.iters)})
            emit({"shape": shape, "kind": kind, "sweep": sorted(sweep, key=lambda s: s["ms"])})
        del deltas
    torch.cuda.empty_cache()
    crossover(ks, sm, dev, rng, args.iters, emit, card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
