#!/usr/bin/env python3
"""Smoke run of multiverso_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The card (``nvidia-smi`` name and power limit), ``torch.version.cuda``
   and ``nvcc --version``.
2. Build the CUDA kernels from ``multiverso_tpu_torch/csrc`` and the
   native library from ``multiverso_tpu_torch/native`` (first use).
3. Kernels: the scatter and the gather against their plain PyTorch
   versions on the card, bit for bit: on the main path's table (1M x 50,
   rows padded to whole 16-byte vectors) at every id bucket 64..65536 with
   sentinel pads, in float32, float64, float16, int32 and int64 (the
   gather with repeated ids); at rows of 1, 3, 13, 32 and 15,552 vectors
   (the last wider than a block's shared memory); on the LDA path's
   102,661 x 1,000 fp32 word-topic table (250 vectors a row) at every
   bucket 64..65536, the gather's grid walking from the pulls' 32,768
   slots on; with out-of-range ids
   (the gather writes zeros, the scatter skips them); and both scatters on
   special values (signed zeros, subnormals, infinities) in each float
   dtype and in both of the simple scatter's paths. Then the card's launch
   floor (``fill_`` on a one-element tensor, back to back) and CUDA-event
   times at the main path's shape (1024 ids, 1024 id sets in rotation so
   the rows come from HBM) for the kernel, its plain version and the
   PyTorch library call, beside the bytes bound. Then the word2vec chunk
   step's kernel chain (``csrc/sgns.cu``) against its plain version at the
   benchmark's chunk (8192 tokens, dim 300, window 5, 5 negatives shared
   by 8 centres) in both of its spaces (3,000,001 rows with unigram
   negatives; 180,000 compact rows with a 16,384-slot table): deltas,
   loss and pairs within float32 reordering, two runs bit for bit; its
   CUDA-event time, the plain version's, the bytes bound, and the kernels
   a whole chunk step launches through each (the profiler's count).
4. The coalesced scatter against its plain version and against the simple
   scatter, exactly: buckets 64..16384 (and 65536 for float32), float32,
   float64 and int32, three id patterns (sorted zipf-unique as word2vec
   pushes them, all-consecutive runs, random unique), each with sentinel
   pads and a segment that ends on the sentinel row. Then times of both
   scatters and ``index_add_`` at the word2vec push shape (a 65,536-slot
   bucket of sorted zipf ids into 100,001 x 128 fp32), where both scatters
   and the gather are first held exactly against ``index_add_`` and
   ``index_select``, and at the PS shape; the gather and ``index_select``
   at the staged word2vec pull shape (the same 65,536-slot buckets).
5. Parameter server: ``mvt.init(local_workers=4)`` on the card; four
   worker threads send 1024-row Adds (random ids, duplicates included) and
   1024-row Gets to a 1M x 50 default-updater matrix table (the kernel
   path), then Adds to an AdaGrad matrix table and an array table. Each
   table is checked against a host numpy mirror of every Add; every
   kernel's launch count over this phase must be > 0. Then the table
   API's other paths (whole-table and device-resident IO, sparse
   staleness, an int32 table, the array table's device sync) against
   numpy. At the end of the drive the three tables (1.2 GB at
   logical dims, the AdaGrad state for 4 workers) are snapshotted with
   ``CheckpointDriver`` into a temporary directory; the runtime restarts,
   the tables are re-created and ``restore_tables`` loads them: data and
   states bitwise equal to host copies taken before the snapshot, the
   column pads and sentinel rows zero (store and restore GB/s).
6. word2vec at the full width of the bench recipe (vocab 100,000, dim 128,
   window 5, 5 negatives shared by 8 centres, 32,768-pair chunks, 8192-token
   blocks, zipf corpus from seed 0): one group-1 ``PSTrainer`` submission on
   the card against the same submission run by the port on the CPU (same
   tables, same injected draws), once with each scatter;
   ``PSTrainer.train`` over group-64 submissions from the same start with
   ``rows.COALESCE`` off and on in turns (words/s each), then off and on
   in deterministic mode (end states bitwise equal); a profiled submission; gather, scatter and coalesced
   scatter each launched over the phase; a ``DeviceTrainer`` corpus step
   over 40 blocks (words/s, finite loss). The chunk step's chain launches
   4 kernels a chunk step over the submissions, the corpus step and the
   profiled submissions, each counted apart (so too in phases 8, 14's
   client and 19's ranks).
7. The consistency servers: the PS phase's 1M x 50 table and four worker
   threads, each round one 1024-row Add and then one 1024-row Get, under
   ``-sync``, ``-ssp_staleness=2`` and ``-deterministic`` (twice, the
   second run with jittered workers). Every Get also reads one counter row
   per worker, which holds the contract: under BSP each round's Get equals
   the host mirror after exactly that many rounds of every worker; under
   SSP no worker is read more than 2 rounds behind. BSP and SSP end equal
   to the mirror (rtol 1e-6), the two deterministic runs bitwise equal.
8. word2vec's staged path (``get_device_async`` -> step ->
   ``add_device_async``) at the bench recipe's width: ``-sync`` with one
   worker (card against CPU, then timed), ``-ssp_staleness=2`` with two
   workers on disjoint blocks, ``-deterministic`` twice: the two runs'
   tables must be bitwise equal (under the flag the step sums duplicate
   rows in index order, without atomics).
9. Logistic regression on synthetic data: the CTR shape (39 active hashed
   features of 2^24, minibatch 256) through the sparse table (sgd) and
   the sparse FTRL table, and MNIST's 784 features through the array
   table (10-class softmax) and the dense FTRL table; each card run
   against the CPU on one minibatch, then timed. Phases 7-9 print the
   scatter and gather launch counts over the phase; 7 and 8 need both.
10. Checkpoints at full width. Resume exactness: one worker plays a
   seeded stream of 1024-row rounds (an Add to the 1M x 50 default and
   AdaGrad matrices, a Get) 2R times uninterrupted, then R times,
   snapshot, restart, restore, R more: final data and AdaGrad states
   bitwise equal (adds/s of each run). word2vec from a file: a zipf corpus
   (the bench vocabulary, 4.5M tokens) written as text, read by
   ``Dictionary.from_text_file(min_count=5)`` and ``iter_token_blocks``
   (tokens/s), two group-64 ``PSTrainer`` submissions, snapshot, restart,
   restore (bitwise), two more, against four uninterrupted ones with the
   same injected draws (rtol 1e-4, atol 1e-6); the embeddings through
   ``save_embeddings``/``load_embeddings`` byte for byte (words/s before
   and after). Logistic regression from config files: ``Configure`` ->
   ``make_reader`` -> ``PSLogReg`` on the sparse FTRL table (a CTR libsvm
   file of 32 minibatches of 256), the sparse table and the dense FTRL
   table, the reader's batches equal to the data written; the three
   tables restored bitwise (examples/s). The scatter and gather must
   launch over the resumed PS rounds and the resumed word2vec
   submissions.
11. The device hash KV table at the lightLDA shape: 64 Adds of 65,536
   word-topic keys (``word * 1000 + topic``, words from the bench's zipf
   counts, topics uniform; value 1.0) into ``create_table("kv",
   capacity=...)`` sized for them and into one that starts at 2^16 and
   rebuilds; whole-table Get, 100,000 point Gets and a store/load round
   trip equal to a numpy mirror exactly; Add and Get keys/s, rebuilds,
   capacity and bytes, the operators and kernels of one ``hash_add``.
12. The query plane through ``mvt.query``/``table.query``: a 1M x 50
   matrix (16 vectors, k = 16, dot and cosine, after 8 acknowledged
   1024-row Adds: a query drained with queued Adds is answered before
   them, as the JAX dispatcher's priority lanes do), a
   word2vec ``w_in`` (100,001 x 128, 10 nearest by cosine), an integer
   grid with exact ties across the k boundary, a sparse table of 200,000
   rows of width 8, and a tiered sparse table of 600,000 keys x 8 at 10x
   its hot budget (8-bit cold segments, no promotion), each against a
   numpy oracle (ids exact, ties included; scores rtol 1e-5, atol 1e-6);
   queries/s and p50/p99 ms a call.
13. Model-averaging ASGD at the reference's published shape: ResNet-32,
   width 16 (464,154 parameters, one 1.86 MB float32 array table), batch
   128, bf16 autocast, 10,240 synthetic CIFAR images, 2 epochs a row
   (row 3: 8): 1 worker without the PS, 1 worker through ``ASGDTrainer``
   (a sync a batch; both at lr 0.01, momentum 0.9), 4 workers (lr 0.02,
   momentum 0.5), 4 workers pipelined; images/s, s/epoch, worker-side sync
   p50/p99, training-set accuracy, the PS overhead of row 2 over row 1,
   the card's idle share over a traced epoch of row 3 (``profile``: the
   union of the device spans traced from every thread). Checks: the port
   in float32 (TF32 off, depth 8) on the card against the CPU, logits and
   parameters after 3 steps and a sync; one ResNet-32 step in bf16 and in
   float32 on the card against the CPU's float32 step; every row's table
   equal to init + the float64 sum of the deltas its workers pushed (4 x
   41 pushes in 2 epochs); rows 1-2 above ``ASGD_ROW12_BAR`` and within
   ``ASGD_ROW12_GAP`` of each other, row 3 above ``ASGD_LEARN_BAR``; BSP
   with 2 workers for 8 rounds (equal pulls each round, the sum again);
   row 3's table checkpointed and restored bitwise into a fresh world;
   ``mvt.aggregate`` across 4 workers of host arrays, host leaf lists and
   device tensor lists in ResNet-32's leaf shapes, equal to numpy's sum,
   each worker's device result its own buffers (ms a call). No row
   kernel runs here: the array table's update and the model are torch
   operators, as they are XLA in the JAX package.
14. Serving over the wire: the tables stay in this process on the card and
   ``mvt.serve`` answers client processes (this script with ``--client``,
   fresh interpreters; they import no JAX and, but for leg 5, touch no
   card). Leg 1: the PS phase's three tables (1M x 50 default and AdaGrad
   matrices, the array table) and 4 clients of 128 rounds over TCP (a
   1024-row Add and Get, an AdaGrad Add, an array Add): adds/s, Add and
   Get p50/p99 µs, every table against a host mirror of every Add (rtol
   and atol 1e-5), the stats RPC's ``SERVER_PROCESS_ADD_MSG`` accounting
   for every Add sent, the scatter and the gather launched in this
   process. Leg 2: ``bench.py``'s apply path (65,536 x 128, 1024-row
   Adds, 400 Adds from 4 producer threads, a window of 32) over shm with
   ``apply_batch_msgs`` 64 and 0 and over TCP with 64: GB/s, adds/s,
   ``APPLY_BATCH_ROWS`` p50, fused calls (> 0 exactly on the fused legs),
   each table bitwise equal to its mirror. Leg 3: BSP over the wire, 2
   clients and 8 rounds, every Get bitwise equal to the mirror after
   exactly that round; then a third client killed with SIGKILL after its
   5th Add, the survivors going on once its 2 s lease expires
   (``WORKER_EVICTIONS`` 1, a flight dump naming the worker). Leg 4,
   integer-valued deltas, each table bitwise equal to the mirror of the
   acknowledged Adds: Add replies dropped (``drop:type=Reply_Add,every=7``,
   retransmits through the dedup window), backlog shedding
   (``admission_queue_limit`` 32), deadlines (20 ms); a planted double
   apply and a planted shed apply must each break the equality. Leg 5:
   ``PSTrainer`` on remote proxies of word2vec's tables at the bench
   recipe's width, its step on the card in the client's process: one
   block against the same block stepped on the CPU by a second client
   (``W2V_RTOL``, ``W2V_ATOL``), then 16 blocks timed (words/s); the
   scatter and the gather launched in this process.
15. Durable serving at configuration 1's width (the three tables of leg
   1). Leg 1: phase 14's leg 1 with a write-ahead log, under
   ``wal_sync=batch`` and ``always`` (32 rounds a client): adds/s and
   Add/Get p50/p99 beside phase 14's, append and fsync p50, log bytes
   and MB/s, every Add logged once. Leg 2: a primary in a child process
   on the card (this script with ``--durable-primary``) dies after
   logging an Add (``after_append``); this process re-creates the
   tables, ``durable_recover``s and serves on its port while the
   client's retransmit settles; a ``CheckpointDriver(wal=...)``
   snapshot; a second child recovers from that generation and dies
   between a fused batch's appends and its apply (``mid_batch``); this
   process recovers again: every table (the AdaGrad one against a numpy
   float32 mirror) bitwise equal to the mirror of the acknowledged Adds;
   recovery and kill-to-serving seconds, records/s. Leg 3: a warm
   standby here tails a child primary (2 s lease), 2 client processes
   train (async, then BSP), the primary is SIGKILLed after 3 rounds at a
   round boundary: the standby takes over, the final tables are bitwise
   the fault-free sums, ``FAILOVERS`` counts; kill to ``took_over`` and
   to the first acknowledged Add. Leg 4: a read replica here, a writer
   adding ones to a block of rows, Gets with ``read_preference``
   replica, hedged and primary: each replica Get one primary state within
   ``read_staleness_records`` 32, the primary's Gets moving only by the
   fallbacks, the lag within the budget; p50/p99. Leg 5: ``mvt.audit``
   of the primary and the replica equal at a common watermark, then a
   corrupt row planted on the replica caught. The scatter must launch in
   this process over legs 2-3 and the gather over leg 4.
16. Sharded serving at configuration 1's width: the three tables
   range-sharded over 2 serving processes on this card
   (``mvt.serve_sharded(..., shards=2, durable=True, device="cuda")``),
   reached through router clients (``ShardedClient``) that hold no table
   state. Leg 1: 4 client processes (``--client``) of 32 rounds (a
   1024-row Add and Get on the default matrix, an AdaGrad Add of the
   client's own rows, an array Add, integer-valued): adds/s and Add/Get
   p50/p99 beside phase 14's unsharded leg 1, every table bitwise equal to
   the host mirror (AdaGrad's a numpy float32 mirror), a second client
   bootstrapped from one endpoint (``mvt.shard_connect``), a top-k query
   merged across the shards against the numpy oracle, then the fleet
   calls on the group (``mvt.stats_all``, ``traces``, ``attribution``,
   ``chargeback``, ``top``): each non-empty, the stitched spans in causal
   order, the chargeback shares summing to 1. Leg 2: 2 writer
   threads add while ``mvt.reshard(group).split(0)`` and then
   ``merge(0)`` run: zero acknowledged Adds lost (bitwise), 2 migrations
   completed and none aborted, both clients on the new layout version;
   seconds to cutover, the transfer's MB and seconds, the records the
   joiners replayed. Leg 3: an acknowledged Add sent as a raw frame,
   ``mvt.cut_fleet``, ``mvt.restore_fleet`` as a fresh group on the card:
   every table's digest equal to the manifest's, the tables bitwise equal
   to the mirror at the fence, the Add resent byte for byte answered from
   the seeded dedup window and not applied; cut and restore seconds. Leg
   4: a group with a standby and a read replica a shard; replica-preferred
   Gets within ``read_staleness_records``; shard 1's primary SIGKILLed at a
   round boundary, shard 0 serving alone meanwhile, the standby taking
   over: the tables bitwise the fault-free sums, ``FAILOVERS`` 0 and 1;
   kill to ``took_over`` and to the first acknowledged Add. Each shard
   process writes its row-kernel launch counts when it is stopped: the
   scatter and the gather must launch in leg 1's primaries, the scatter
   in leg 2's joiners and leg 3's restored shards, the gather in leg 4's
   replicas.
17. LDA at the UCI Bag-of-Words NYTimes corpus's shape (vocabulary
   102,660, 332 tokens a document, 1,000 topics, alpha 50/K, beta 0.01)
   on a planted-topic synthetic corpus of 1,024 documents:
   ``mvt.init(local_workers=4)`` on the card with ``metrics_path`` set, 4
   worker threads each running a ``PSGibbsLDA`` over 256 documents
   against one shared 102,660 x 1,000 word-topic matrix table and one
   topic-total array table, 10 sweeps: the table bitwise equal to the
   counts implied by every worker's assignments, the totals to its
   column sums, the grand total to the 339,968 live tokens; sweep ms
   p50/p99 (pull, sweep function, push), tokens/s over the workers, the
   sweep function's CUDA-event ms; both row kernels launched; one pull's
   reply bitwise equal to ``gather_rows_plain`` and one sweep's delta
   push to ``scatter_add_rows_plain`` on the same table and padded ids;
   the card's busy share over one more profiled round (``profile``, as
   phase 13's idle share); the phase's peak device memory; a metrics
   snapshot holding ``SERVER_PROCESS_ADD_MSG``. Then the planted-topic
   case of ``tests/test_lda.py`` on the card under the port's lockcheck
   (purity > 0.9, no lock-order cycle), the ``lda_topics`` example twin
   (purity > 0.8), and that case on the card against the CPU from the
   same numpy draws for 3 sweeps: equal assignments except at counted
   near-ties.
18. The self-driving control plane. Leg 1: the fleet autopilot
   (``mvt.autopilot(group, interval=0, recorder=...)``, ticked by hand)
   over configuration 10's fleet: phase 16's three tables at full width
   on 2 durable shard processes, one warm-up Add across both shards, then
   2 writer threads adding 256 distinct rows an Add, zipf(1.1) by rank
   over shard 0's range, integer deltas in [0, 5). Tick 1, once at least
   64 Adds acknowledged in the window reached shard 0 (no fixed sleep):
   a split of shard 0 through the migration coordinator while the
   writers go on (3 shards, layout v2). Tick 2, the writers stopped and
   read hedges counted: a read replica added, caught up to its primary's
   watermark, replica-preferred Gets equal to the mirror. Tick 3: the
   replica flips a row of its table on the card
   (``fault.inject.corrupt_table_row`` through ``MV_AUDIT_CORRUPT``), an
   ``mvt.audit`` check catches it, the loop freezes, a tick while frozen
   is skipped, ``ack()`` unfreezes it. ``AUTOPILOT_ACTIONS`` 2; the whole
   table through a fresh client bitwise equal to the writers' mirror; the
   scatter launched in both primaries and both joiners, the gather in
   the replica; each tick's sense and decide ms, the split's seconds,
   transfer and records replayed, the replica's seconds to caught up,
   the writers' Add p50/p99 before, during and after the split. Leg 2:
   the knob tuner (``KnobController`` driven by ``tick_now``) on
   configuration 1's matrix served from this process under
   ``wal_sync=always`` and ``apply_batch_msgs`` 0, 4 client threads
   adding integer-valued 1024-row Adds: one pass reading the dispatcher
   thread's waits (``wal_fsync`` dominant: ``apply_batch_msgs`` 0 to 8),
   one the whole process's; each pass's step is the first rule its sense
   matches, its commit or revert agrees with the objective printed
   beside it, and the flight records replay to the live flag value; the
   table bitwise equal to the mirror; the scatter launched.
19. The multi-process PS: a 2-rank ``torch.distributed`` world (gloo),
   both ranks on the one card, each a process of this script
   (``--multihost-rank``) with 2 local workers (configuration 1's 4).
   Leg 1: configuration 1's 1M x 50 fp32 matrix split 500,000 rows a rank,
   128 async rounds of a 1024-row Add (integer deltas) and Get from every
   worker, 50 4-row sync Adds a rank (the control plane's cost an op),
   then, in a BSP world restored from leg 3's snapshot, 32 BSP rounds; the
   final whole-table read bitwise equal to a numpy mirror on both ranks;
   the scatter and the gather launched in both ranks. Leg 2: word2vec at
   configuration 2's width (vocabulary 100,000, dimension 128), 8
   8192-token blocks through the named block transaction, the ranks in
   turn with host draws: both ranks' views of the tables equal, the loss
   falling, the tables and losses within W2V_RTOL/ATOL of a one-process
   port run fed the same blocks and draws. Leg 3: the snapshot (leader
   writes, every rank reads its rows) and the restore of leg 1's table,
   bitwise; one ``mvt.aggregate`` of a 1.86 MB vector (configuration 7's
   table) per worker, equal bit for bit to the sum in the reference's
   order. Adds/s, Add and Get p50/p99, the Get exchange's ms, the control
   plane's ms an op, words/s, snapshot and restore seconds.
20. Sequence parallelism and the native layer. Leg 1: a 4-rank gloo
   world on the one card, each rank a process of this script
   (``--ring-rank``) on its own gloo group: ring attention at a global T
   of 16,384 (4,096 a rank; B 1, H 8, D 64, fp32) plain, causal and with a
   relative-position ``bias_fn``, and the Ulysses reshard to heads and back
   around attention, each gathered on rank 0 and held against
   ``reference_attention`` on the card from the gathered inputs
   (SP_FWD_TOL); the backward (dq, dk, dv, d(rel) of sum(out * w), causal
   with the bias) at a global T of 2,048 against autograd through the
   reference (SP_GRAD_TOL); forward, forward+backward, Ulysses, one hop
   (and its host staging and gloo parts) and the reference in ms, each
   rank's peak memory. Then the long-context LM twin at the JAX example's
   defaults on 4 ranks: the loss falls, the echo accuracy is above 0.9
   and the table holds the trained model after the sync. Leg 2: the
   port's ``libmultiverso_tpu.so`` built from the sources, then from this
   process through ctypes ``MV_Init`` on the card and configuration 1's
   1M x 50 matrix: 1024-row Adds (integer deltas) and Gets through the C
   API and then the Python API, every Get and the final whole table
   bitwise equal to a numpy mirror, the table on the card, the scatter and
   the gather launched by the C API's rounds (counted over those rounds
   alone; the Python API's rounds are counted apart); the C client and the Lua FFI replay (the XOR net
   learns) as child processes on the card where ``sysconfig`` shows a
   shared libpython; the native codecs byte for byte against numpy
   (sparse, dense, 4-bit); ``load_libsvm_native`` against the Python
   parser on a generated file.
21. The run's seconds, one JSON line listing every kernel (with its
   launches in the shard processes, over phases 17 and 18, in each rank of
   phase 19 and through phase 20's C API), then the last line
   ``{"ok": true, "device": {...}}``.

It needs the card: without CUDA it exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# cuBLAS needs a fixed workspace for the deterministic word2vec runs
# (torch.use_deterministic_algorithms); set before any cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROWS, COLS, BATCH = 1_000_000, 50, 1024   # the reference's matrix perf harness
WORKERS = 4
BUCKETS = [64 << k for k in range(9)]      # 64 .. 16384
KERNEL_BUCKETS = [64 << k for k in range(11)]  # 64 .. 65536
KERNEL_DTYPES = (np.float32, np.float64, np.float16, np.int32, np.int64)
# 16-byte vectors a row: one, an odd width, the PS row (52 fp32), the
# word2vec row (128 fp32), and a row (243 KB) wider than the 227 KB of
# shared memory a block can have
ROW_WIDTHS = [1, 3, 13, 32, 15_552]
PS_ID_SETS = 1024                          # id sets in rotation at the PS shape
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM non-tensor fp32, data sheet
# the word2vec chunk step at the benchmark's chunk (w2v_gnews_300), in the
# device trainer's space (3M words, unigram negatives) and the PS
# transaction's (about 180,000 compact rows, a 16,384-slot table)
SGNS_CHUNK = dict(t=8192, dim=300, window=5, negatives=5, group=8)
SGNS_SPACES = {"device": (3_000_001, False), "ps": (180_000, True)}
SGNS_SLOTS = 16384
# the chain against its plain version: float32 sums in another order
# (tests/test_torch_sgns_chunk.py states the same tolerances)
SGNS_RTOL, SGNS_ATOL_SCALE, SGNS_LOSS_RTOL = 1e-4, 1e-5, 1e-5
# word2vec: the bench recipe (bench.py bench_ps_word2vec / bench_word2vec)
W2V = dict(vocab_size=100_000, dim=128, window=5, negatives=5,
           batch_pairs=32768, block_tokens=8192, sample=0.0, neg_sharing=8)
W2V_GROUP = 64                             # 8192-token blocks per submission
W2V_SUBMISSIONS = 4
W2V_DEVICE_BLOCKS = 40
# the card against the CPU: index_add_ on the card sums a step's duplicate
# rows with atomics, in an order that changes from run to run. Over a few
# group-64 submissions that order alone moves some weights by more than
# this, so COALESCE off and on are compared in deterministic mode, where
# they must be bitwise equal.
W2V_RTOL, W2V_ATOL = 1e-4, 1e-6
# fp32 sums taken in another order than the mirror's (fused micro-batches,
# merged duplicates, AdaGrad steps from 4 workers interleaved): a few
# roundings of values of order 1 to 10
RTOL, ATOL = 1e-5, 1e-5
# the consistency servers against the float64 mirror: a row takes a few
# linear Adds of order 1, summed in float32 in arrival order
MODES = {"bsp": dict(sync=True), "ssp2": dict(ssp_staleness=2),
         "deterministic": dict(deterministic=True)}
MODE_ROUNDS = 32
MODE_RTOL, MODE_ATOL = 1e-6, 1e-6
STAGED_BLOCKS = 8                          # 8192-token blocks per worker
# logistic regression: Criteo's 13 integer + 26 categorical fields hashed
# into 2^24 keys; MNIST's 784 features
CTR_KEYS, CTR_FIELDS = 1 << 24, 39
MNIST_FEATURES = 784
LR_BATCHES = 32
LR_RTOL, LR_ATOL = 1e-5, 1e-6
JOIN_S = 600
# checkpoints: 1024-row rounds of the resume-exactness stream (R of 2R
# before the restart); the word2vec corpus (the bench vocabulary, every
# word at least min_count = 5 times, lines of 1000 tokens)
RESUME_ROUNDS = 64
W2V_FILE_TOKENS = 4_000_000
W2V_LINE_TOKENS = 1000
# the device KV table: lightLDA word-topic counts (tests/test_kv_table.py's
# stress at a user's size): Adds of zipf-word x uniform-topic keys
KV_ADDS, KV_DRAWS, KV_TOPICS = 64, 65_536, 1000
KV_POINT_GETS = 100_000
# the query plane against its numpy oracle: float32 scores from another
# summation order (cuBLAS against numpy's BLAS), a normalisation for cosine
QUERY_RTOL, QUERY_ATOL = 1e-5, 1e-6


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, iters: int) -> float:
    """Device time per call: a sleep kernel holds the stream while the host
    enqueues ``iters`` calls, so the events time the calls back to back
    and not the host's launch overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_rows(rng, shape, np_dtype) -> np.ndarray:
    """Table or delta rows: integers in [-1000, 1000) or normal floats."""
    if np.issubdtype(np_dtype, np.integer):
        return rng.integers(-1000, 1000, size=shape, dtype=np_dtype)
    return rng.standard_normal(shape).astype(np_dtype)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, for comparisons that tell -0.0 from 0.0."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_rows(rows, table, np_dtype, rng, B: int, sentinel: int, label: str):
    """The scatter (unique live ids, sentinel pads with zero deltas) and the
    gather (repeated ids, sentinel pads) against their plain versions on
    ``table``, bit for bit. Returns (max |err| scatter, gather)."""
    live = B - B // 8
    ids = np.full(B, sentinel, np.int32)
    ids[:live] = rng.choice(sentinel, live, replace=False)
    d = random_rows(rng, (B, table.shape[1]), np_dtype)
    d[live:] = 0
    ids_t, d_t = torch.from_numpy(ids).to(table.device), torch.from_numpy(d).to(table.device)
    got = rows.scatter_add_rows(table.clone(), ids_t, d_t)
    want = rows.scatter_add_rows_plain(table.clone(), ids_t, d_t)
    torch.cuda.synchronize()
    e_s = (got.double() - want.double()).abs().max().item()
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"scatter_add_rows {label} B={B}: max |kernel - plain| = {e_s}")
    del got, want
    gids = np.full(B, sentinel, np.int32)
    gids[:live] = rng.integers(0, sentinel, live)
    gids_t = torch.from_numpy(gids).to(table.device)
    g = rows.gather_rows(table, gids_t)
    gw = rows.gather_rows_plain(table, gids_t)
    torch.cuda.synchronize()
    e_g = (g.double() - gw.double()).abs().max().item()
    if not torch.equal(bits(g), bits(gw)):
        raise AssertionError(f"gather_rows {label} B={B}: max |kernel - plain| = {e_g}")
    return e_s, e_g


def check_out_of_range(rows, table, rng) -> None:
    """Ids outside [0, rows) reach the kernels (the table layer rejects them
    first; a wrapper does not): the gather writes zeros for them, the
    scatter skips them and leaves every other row as index_add_ does."""
    R, C = table.shape
    B = 1024
    ids = np.full(B, R - 1, np.int32)
    ids[:900] = rng.choice(R - 1, 900, replace=False)
    bad = [3, 500, 899]
    ids[bad] = [-1, R, 2 ** 31 - 1]
    d = rng.standard_normal((B, C)).astype(np.float32)
    d[900:] = 0
    fixed_ids, fixed_d = ids.copy(), d.copy()
    fixed_ids[bad], fixed_d[bad] = R - 1, 0  # the same Add without the bad slots
    dev = table.device
    got = rows.scatter_add_rows(table.clone(), torch.from_numpy(ids).to(dev),
                                torch.from_numpy(d).to(dev))
    want = table.clone().index_add_(0, torch.from_numpy(fixed_ids).to(dev),
                                    torch.from_numpy(fixed_d).to(dev))
    g = rows.gather_rows(table, torch.from_numpy(ids).to(dev))
    g_want = table.index_select(0, torch.from_numpy(fixed_ids).to(dev))
    g_want[bad] = 0
    torch.cuda.synchronize()
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError("scatter_add_rows touched a row for an out-of-range id")
    if not torch.equal(bits(g), bits(g_want)):
        raise AssertionError("gather_rows: an out-of-range id did not give a zero row")


# values where an add could round or flush differently: signed zeros,
# subnormals, the smallest and largest normals, infinities
SPECIAL = {
    np.float32: [0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                 -1.1754942e-38, 1.0, -1.0, 3.4e38, -3.4e38],
    np.float64: [0.0, -0.0, 5e-324, -5e-324, 1e-310, -2e-308, 2.2250738585072014e-308,
                 -2.2250738585072014e-308, 1.0, -1.0, 1.7e308, -1.7e308],
    np.float16: [0.0, -0.0, 6e-8, -6e-8, 3e-5, -3e-5, 6.104e-05, -6.104e-05,
                 1.0, -1.0, 65504.0, -65504.0],
}


def check_special_values(rows, mesh, dev, rng) -> int:
    """Both scatters on special values (tables with infinities too), bit
    for bit against index_add_ on the card, in each float dtype and in both
    of the simple scatter's paths (a 64-slot batch adds in L2, a
    65536-slot one through the SM). Returns the number of checks."""
    checks = 0
    for np_dtype, values in SPECIAL.items():
        C = mesh.padded_cols(COLS, np_dtype)
        vecs = C * np.dtype(np_dtype).itemsize // 16
        if [rows.scatter_launch(B, vecs, 1)[1] for B in (64, 65536)] != [True, False]:
            raise AssertionError(f"{np.dtype(np_dtype).name}: the special-value "
                                 "batches do not take both scatter paths")
        deltas_from = np.array(values, np_dtype)
        table_from = np.concatenate([deltas_from, np.array([np.inf, -np.inf], np_dtype)])
        table = torch.from_numpy(rng.choice(table_from, (70_001, C))).to(dev)
        for B in (64, 65536):
            ids = torch.from_numpy(rng.choice(70_000, B, replace=False).astype(np.int32)).to(dev)
            d = torch.from_numpy(rng.choice(deltas_from, (B, C))).to(dev)
            want = bits(table.clone().index_add_(0, ids, d))
            for k in (rows.scatter_add_rows, rows.scatter_add_rows_coalesced):
                got = k(table.clone(), ids, d)
                torch.cuda.synchronize()
                if not torch.equal(bits(got), want):
                    raise AssertionError(
                        f"{k.__name__} {np.dtype(np_dtype).name} B={B} on special values: "
                        f"{int((bits(got) != want).sum())} elements differ from index_add_")
                checks += 1
        del table
    return checks


def lda_shape_checks(rows, dev, rng, err: dict):
    """Both row kernels at the LDA path's shape, bit for bit against their
    plain versions: the 102,661-row word-topic table (the sentinel row
    last) of 1,000 fp32 columns (250 16-byte vectors a row), every bucket
    from 64 slots past the pulls' 32,768, so the gather's grid walks (more
    slots than its capped grid takes in one pass) on rows wider than a
    block's 32 lanes. Folds the errors into ``err``; returns (cases, the
    buckets at which the gather walks)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(LDA_SEED)
    table = torch.randn((LDA_VOCAB + 1, LDA_TOPICS), generator=gen, device=dev)
    vecs = LDA_TOPICS * 4 // 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, walks = 0, []
    for B in KERNEL_BUCKETS:
        e = check_rows(rows, table, np.float32, rng, B, LDA_VOCAB,
                       f"LDA table, {vecs} vectors a row")
        err["scatter_add_rows"] = max(err["scatter_add_rows"], e[0])
        err["gather_rows"] = max(err["gather_rows"], e[1])
        g = rows.launch_geometry(B, vecs, sms, *rows.GATHER_BLOCK)
        if g.grid * g.block_y < B:
            walks.append(B)
        cases += 1
    if LDA_PULL_BUCKET not in walks:
        raise AssertionError(f"the gather's grid does not walk at the LDA "
                             f"pull's {LDA_PULL_BUCKET}-slot bucket")
    del table
    torch.cuda.empty_cache()
    return cases, walks


def kernel_phase(rows, mesh, dev):
    """Compare the gather and the scatter with their plain versions; time
    both and the library call at the PS shape. Returns (per-kernel
    results, the launch floor in ms)."""
    rng = np.random.default_rng(0)
    R = ROWS + 1  # + the sentinel row, as MatrixServer lays the table out
    sentinel = ROWS
    err = {"scatter_add_rows": 0.0, "gather_rows": 0.0}
    checked = 0
    for np_dtype in KERNEL_DTYPES:
        C = mesh.padded_cols(COLS, np_dtype)
        table = torch.from_numpy(random_rows(rng, (R, C), np_dtype)).to(dev)
        for B in KERNEL_BUCKETS:
            e = check_rows(rows, table, np_dtype, rng, B, sentinel,
                           np.dtype(np_dtype).name)
            err["scatter_add_rows"] = max(err["scatter_add_rows"], e[0])
            err["gather_rows"] = max(err["gather_rows"], e[1])
            checked += 1
        if np_dtype == np.float32:
            check_out_of_range(rows, table, rng)
        del table
    special = check_special_values(rows, mesh, dev, rng)
    # row widths: a 16-byte vector, odd widths, the PS and word2vec rows,
    # and a row wider than a block's shared memory, each with sentinel pads
    widths = 0
    for vecs in ROW_WIDTHS:
        n_rows = 257 if vecs > 1024 else 4097
        table = torch.from_numpy(random_rows(rng, (n_rows, vecs * 4), np.float32)).to(dev)
        for B in ((64, 256) if vecs > 1024 else (64, 1024, 4096)):
            check_rows(rows, table, np.float32, rng, B, n_rows - 1,
                       f"{vecs} vectors a row")
            widths += 1
        del table
    lda_cases, walks = lda_shape_checks(rows, dev, rng, err)
    print(f"kernel phase: {checked} (dtype, bucket) cases on the 1M x 50 table "
          f"(dtypes {[np.dtype(t).name for t in KERNEL_DTYPES]}, buckets "
          f"{KERNEL_BUCKETS[0]}..{KERNEL_BUCKETS[-1]}), {widths} (row width, "
          f"bucket) cases (widths {ROW_WIDTHS} vectors) and {lda_cases} bucket "
          f"cases on the {LDA_VOCAB} x {LDA_TOPICS} LDA table (the gather's "
          f"grid walks at buckets {walks}), kernels bitwise equal "
          f"to their plain versions (max |err| {err}); out-of-range ids: gather "
          f"zeros, scatter skips; {special} special-value checks of both "
          f"scatters bitwise equal to index_add_", flush=True)

    # times at the main path's shape: 1024 unique ids into the fp32 table,
    # PS_ID_SETS id sets in rotation: the rows touched between two uses of
    # a set (218 MB) are over 4x the L2, so the rows come from HBM. The
    # card's launch floor just before, on the same clocks
    floor = launch_floor_ms(dev)
    C = mesh.padded_cols(COLS, np.float32)
    table = torch.zeros((R, C), dtype=torch.float32, device=dev)
    id_sets = torch.from_numpy(np.stack(
        [rng.choice(ROWS, BATCH, replace=False).astype(np.int32)
         for _ in range(PS_ID_SETS)])).to(dev)
    deltas = torch.from_numpy(
        rng.standard_normal((BATCH, C)).astype(np.float32)).to(dev)
    it = iter(range(1 << 62))

    def ids():
        return id_sets[next(it) % PS_ID_SETS]

    iters = 400
    times = {
        "scatter_add_rows": (
            device_ms(lambda: rows.scatter_add_rows(table, ids(), deltas), iters),
            device_ms(lambda: rows.scatter_add_rows_plain(table, ids(), deltas), iters),
            device_ms(lambda: table.index_add_(0, ids(), deltas), iters)),
        "gather_rows": (
            device_ms(lambda: rows.gather_rows(table, ids()), iters),
            device_ms(lambda: rows.gather_rows_plain(table, ids()), iters),
            device_ms(lambda: table.index_select(0, ids()), iters)),
    }
    row_bytes = C * 4
    n_unique = BATCH  # each timed batch holds 1024 distinct ids
    bytes_moved = {
        # ids + deltas read, each touched row read and written once
        "scatter_add_rows": 4 * BATCH + BATCH * row_bytes + 2 * n_unique * row_bytes,
        # ids + each touched row read once, the output written once
        "gather_rows": 4 * BATCH + n_unique * row_bytes + BATCH * row_bytes,
    }
    ops = {"scatter_add_rows": BATCH * C, "gather_rows": 0}
    out = {}
    for name, (k_ms, p_ms, lib_ms) in times.items():
        t_bytes = bytes_moved[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / FP32_OPS_PER_S * 1e3
        out[name] = {"max_abs_err": err[name], "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": bytes_moved[name]}
    del table, id_sets, deltas
    torch.cuda.empty_cache()
    return out, floor


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of ``fn`` while a sleep kernel holds the
    stream: the issue alone, not the device's time."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def sgns_inputs(rng, rows: int, neg_table: bool, dev, c=SGNS_CHUNK):
    """Tables of ``rows`` rows (the first 100,000, or all but the sentinel
    where fewer, uniform in +-0.5/dim), a zipf chunk with a padded tail,
    and its draws."""
    vocab = min(rows - 1, 100_000)
    w_in = torch.zeros((rows, c["dim"]), device=dev)
    w_out = torch.zeros((rows, c["dim"]), device=dev)
    w_in[:vocab].uniform_(-0.5 / c["dim"], 0.5 / c["dim"])
    w_out[:vocab].uniform_(-0.5, 0.5)
    block = zipf_tokens(rng, c["t"], vocab).astype(np.int32)
    block[-300:] = -1
    tg = c["t"] // c["group"]
    win = torch.from_numpy(rng.integers(1, c["window"] + 1, c["t"])).to(dev)
    slots = None
    if neg_table:
        slots = torch.from_numpy(
            rng.integers(0, vocab, SGNS_SLOTS).astype(np.int32)).to(dev)
        neg = rng.integers(0, SGNS_SLOTS, (tg, c["negatives"]))
    else:
        neg = rng.integers(0, vocab, (tg, c["negatives"]))
    return (w_in, w_out, torch.from_numpy(block).to(dev), win,
            torch.from_numpy(neg).to(dev), slots)


def sgns_bytes(args, chunk) -> int:
    """The least bytes a chunk of the chain moves: each distinct table row
    it reads once, each delta row and id written once, the chunk and its
    draws read once."""
    w_in, w_out, block, win, neg, slots = args
    dim = w_in.shape[1]
    rows_read = (int(torch.unique(chunk.ids_in).numel())
                 + int(torch.unique(torch.cat([chunk.ids_out,
                                               chunk.ids_neg])).numel()))
    rows_written = chunk.d_in.shape[0] + chunk.d_out.shape[0] + chunk.d_neg.shape[0]
    return (4 * dim * (rows_read + rows_written) + 8 * rows_written
            + block.numel() * block.element_size()
            + win.numel() * win.element_size()
            + neg.numel() * neg.element_size()
            + (0 if slots is None else neg.numel() * slots.element_size()))


def sgns_phase(dev, card: str) -> dict:
    """The chunk step's kernel chain against its plain version at the
    benchmark's chunk, in both spaces; times, the bytes bound, and the
    kernels one chunk step launches through the chain and through the
    eager body (``cuda_kernels``)."""
    from multiverso_tpu_torch.models import word2vec as w2v_mod
    from multiverso_tpu_torch.models.vocab import Dictionary
    from multiverso_tpu_torch.ops import sgns

    c = SGNS_CHUNK
    kw = dict(window=c["window"], negatives=c["negatives"], group=c["group"],
              max_row_step=1.0)
    rng = np.random.default_rng(18)
    out = {}
    for space, (rows, neg_table) in SGNS_SPACES.items():
        args = sgns_inputs(rng, rows, neg_table, dev)
        err = {}
        for combine in ("sum", "mean"):
            a = sgns.sgns_chunk(*args, 0.025, combine=combine, **kw)
            b = sgns.sgns_chunk(*args, 0.025, combine=combine, **kw)
            want = sgns.sgns_chunk_plain(*args, 0.025, combine=combine, **kw)
            torch.cuda.synchronize()
            for name, x, y, z in zip(sgns.ChunkDeltas._fields, a, b, want):
                if not torch.equal(x, y):
                    raise AssertionError(f"sgns {space}/{combine} {name}: two "
                                         f"runs differ")
                if name.startswith("ids") or name == "pairs":
                    if not torch.equal(x, z):
                        raise AssertionError(f"sgns {space}/{combine} {name} "
                                             f"!= plain")
                    continue
                rtol = SGNS_LOSS_RTOL if name == "loss" else SGNS_RTOL
                atol = (0.0 if name == "loss" else
                        SGNS_ATOL_SCALE * float(z.abs().max()))
                torch.testing.assert_close(
                    x, z, rtol=rtol, atol=atol,
                    msg=lambda m: f"sgns {space}/{combine} {name}: {m}")
                err[f"{combine}/{name}"] = float((x - z).abs().max())
        chunk = sgns.sgns_chunk(*args, 0.025, combine="sum", **kw)
        nbytes = sgns_bytes(args, chunk)
        ms = device_ms(lambda: sgns.sgns_chunk(*args, 0.025, **kw), 200)
        plain_ms = device_ms(lambda: sgns.sgns_chunk_plain(*args, 0.025, **kw),
                             20)
        busy = {k: profile(lambda f=f: f(*args, 0.025, **kw))["device_busy_ms"]
                for k, f in (("chain", sgns.sgns_chunk),
                             ("plain", sgns.sgns_chunk_plain))}

        # one whole chunk step (draws, chain or eager body, three scatters)
        cfg = w2v_mod.Word2VecConfig(
            vocab_size=100_000, dim=c["dim"], window=c["window"],
            negatives=c["negatives"], block_tokens=c["t"],
            neg_sharing=c["group"], sample=0.0)
        d = Dictionary()
        d.counts = w2v_counts(100_000)
        step = w2v_mod.make_block_train_step(cfg, d, neg_table=neg_table,
                                             device=dev)
        sampler = None if neg_table else w2v_mod.unigram_negative_sampler(
            d.counts, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        w_in, w_out, block, _, _, slots = args
        params = {"w_in": w_in, "w_out": w_out}

        def eager_step():
            t, tg = c["t"], c["t"] // c["group"]
            win = torch.randint(1, c["window"] + 1, (t,), generator=gen,
                                device=dev)
            neg = (torch.randint(0, SGNS_SLOTS, (tg, c["negatives"]),
                                 generator=gen, device=dev)
                   if neg_table else sampler((tg, c["negatives"]), gen))
            ch = sgns.sgns_chunk_plain(w_in, w_out, block, win, neg, slots,
                                       0.025, combine="sum", **kw)
            w2v_mod._add_rows(w_in, ch.ids_in, ch.d_in, False)
            w2v_mod._add_rows(w_out, ch.ids_out, ch.d_out, False)
            w2v_mod._add_rows(w_out, ch.ids_neg, ch.d_neg, False)

        before = sgns.sgns_chunk.launches
        step_kernels = cuda_kernels(lambda: step(params, gen, block, 0.025,
                                                 slots))
        chain_launches = sgns.sgns_chunk.launches - before
        host = {"chain_us": host_us(
                    lambda: sgns.sgns_chunk(*args, 0.025, **kw), 100),
                "step_us": host_us(
                    lambda: step(params, gen, block, 0.025, slots), 50)}
        out[space] = {
            "rows": rows, "neg_table": neg_table, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "device_busy_ms": busy["chain"], "plain_device_busy_ms": busy["plain"],
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "step_kernels": step_kernels, "step_chain_launches": chain_launches,
            "eager_step_kernels": cuda_kernels(eager_step), "host": host}
        del args, params, chunk, w_in, w_out
        torch.cuda.empty_cache()
    print(f"sgns chunk (T {c['t']}, D {c['dim']}, W {c['window']}, K "
          f"{c['negatives']}, G {c['group']}) on {card}: {json.dumps(out)}",
          flush=True)
    return out


def launch_floor_ms(dev, iters: int = 400) -> float:
    """The card's launch floor: CUDA-event ms per call of ``fill_`` on a
    one-element tensor, back to back."""
    one = torch.zeros(1, device=dev)
    return device_ms(lambda: one.fill_(1.0), iters)


def w2v_counts(vocab: int) -> np.ndarray:
    """The bench's zipf word counts: max(1e7 / rank, 5)."""
    return np.maximum((1e7 / np.arange(1, vocab + 1)).astype(np.int64), 5)


def zipf_tokens(rng, shape, vocab: int) -> np.ndarray:
    """Token ids drawn from the bench's zipf counts (inverse CDF)."""
    p = w2v_counts(vocab).astype(np.float64)
    cdf = np.cumsum(p / p.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(shape)),
                      vocab - 1).astype(np.int32)


def coalesced_ids(rng, bucket: int, n_rows: int, pattern: str):
    """A push bucket for the coalesced scatter: ``live`` unique ids, the
    last three of them the rows just below the sentinel so that the segment
    ending at slot ``live`` ends on the sentinel row, then sentinel pads.
    Returns (ids, live)."""
    sentinel = n_rows - 1
    live = bucket - bucket // 8 - 1          # slot `live` is the first pad
    body = live - 3
    ids = np.full(bucket, sentinel, np.int32)
    if pattern == "zipf":  # the sorted unique tokens of a submission, as
        # word2vec pushes them: draw until there are enough, then drop
        # the few extra at random
        uniq = np.zeros(0, np.int32)
        while len(uniq) < body:
            more = zipf_tokens(rng, max(64, body // 8), W2V["vocab_size"])
            uniq = np.union1d(uniq, more)
        chosen = np.sort(rng.choice(uniq, body, replace=False))
    elif pattern == "runs":  # every segment consecutive
        start = int(rng.integers(0, sentinel - 3 - body))
        chosen = np.arange(start, start + body)
    else:  # random unique, unsorted
        chosen = rng.choice(sentinel - 3, body, replace=False)
    ids[:body] = chosen
    ids[body:live] = np.arange(sentinel - 3, sentinel)
    return ids, live


def coalesced_phase(rows, mesh, dev, card: str):
    """The coalesced scatter against its plain version and the simple
    scatter, exactly, then times of both scatters at the word2vec push
    shape and the PS shape. Returns (max |err|, {shape: times})."""
    rng = np.random.default_rng(3)
    R = ROWS + 1
    err = 0.0
    checked = 0
    share = {}
    for np_dtype in (np.float32, np.float64, np.int32):
        C = mesh.padded_cols(COLS, np_dtype)
        if np.issubdtype(np_dtype, np.integer):
            host = rng.integers(-1000, 1000, size=(R, C), dtype=np_dtype)
        else:
            host = rng.standard_normal((R, C)).astype(np_dtype)
        table = torch.from_numpy(host).to(dev)
        buckets = BUCKETS + ([65536] if np_dtype == np.float32 else [])
        for B in buckets:
            for pattern in ("zipf", "runs", "random"):
                ids, live = coalesced_ids(rng, B, R, pattern)
                if np.issubdtype(np_dtype, np.integer):
                    d = rng.integers(-50, 50, size=(B, C), dtype=np_dtype)
                else:
                    d = rng.standard_normal((B, C)).astype(np_dtype)
                d[live:] = 0
                ids_t = torch.from_numpy(ids).to(dev)
                d_t = torch.from_numpy(d).to(dev)
                got = rows.scatter_add_rows_coalesced(table.clone(), ids_t, d_t)
                want = rows.scatter_add_rows_coalesced_plain(table.clone(), ids_t, d_t)
                simple = rows.scatter_add_rows(table.clone(), ids_t, d_t)
                torch.cuda.synchronize()
                e = (got.double() - want.double()).abs().max().item()
                err = max(err, e)
                if not (torch.equal(got, want) and torch.equal(got, simple)):
                    raise AssertionError(
                        f"scatter_add_rows_coalesced {np_dtype.__name__} B={B} "
                        f"{pattern}: max |kernel - plain| = {e}, max |kernel - "
                        f"simple| = {(got.double() - simple.double()).abs().max().item()}")
                share.setdefault(pattern, []).append(
                    float(rows.seg_flags(ids_t).float().mean()))
                checked += 1
                del got, want, simple
        del table
    print(f"coalesced phase: {checked} (dtype, bucket, pattern) cases, the "
          f"coalesced scatter equal to index_add_ and to scatter_add_rows "
          f"(max |err| {err}); flagged segments by pattern "
          f"{ {k: [round(x, 3) for x in v] for k, v in share.items()} } "
          f"(buckets {BUCKETS + [65536]} for float32)", flush=True)

    times = {}
    # the word2vec push: the sorted unique tokens of a group-64 submission
    # padded to a 65,536-slot bucket, into the 100,001 x 128 input table
    V, D = W2V["vocab_size"], W2V["dim"]
    sets = []
    for _ in range(4):
        u = np.unique(zipf_tokens(rng, W2V_GROUP * W2V["block_tokens"], V))
        b = max(64, 1 << int(len(u)).bit_length())
        ids = np.full(b, V, np.int32)
        ids[: len(u)] = u
        sets.append((ids, len(u)))
    B = max(len(i) for i, _ in sets)
    sets = [(np.concatenate([i, np.full(B - len(i), V, np.int32)]), n) for i, n in sets]
    flags = float(np.mean([rows.seg_flags(torch.from_numpy(i)).float().mean().item()
                           for i, _ in sets]))
    push_shape_checks(rows, sets, V, D, dev, rng)
    times["w2v_push"] = time_scatters(
        rows, torch.zeros((V + 1, D), dtype=torch.float32, device=dev),
        [torch.from_numpy(i).to(dev) for i, _ in sets],
        int(np.mean([n for _, n in sets])), dev, rng)
    times["w2v_push"].update(bucket=B, flagged_share=flags)
    # the staged word2vec pull: the same buckets gathered from 100,001 x 128
    times["w2v_pull"] = time_gather(
        rows, torch.zeros((V + 1, D), dtype=torch.float32, device=dev),
        [torch.from_numpy(i).to(dev) for i, _ in sets],
        int(np.mean([n for _, n in sets])))
    times["w2v_pull"].update(bucket=B)
    # the PS Add: 1024 random unique ids into 1M x 52
    C = mesh.padded_cols(COLS, np.float32)
    id_sets = [torch.from_numpy(rng.choice(ROWS, BATCH, replace=False).astype(np.int32)).to(dev)
               for _ in range(PS_ID_SETS)]
    times["ps_add"] = time_scatters(
        rows, torch.zeros((R, C), dtype=torch.float32, device=dev), id_sets,
        BATCH, dev, rng)
    times["ps_add"].update(bucket=BATCH, flagged_share=float(np.mean(
        [rows.seg_flags(i).float().mean().item() for i in id_sets])))
    for shape, t in times.items():
        print(f"scatter times at the {shape} shape ({card}): {json.dumps(t)}",
              flush=True)
    torch.cuda.empty_cache()
    return err, times


def push_shape_checks(rows, sets, V: int, D: int, dev, rng) -> None:
    """At the word2vec push shape (each id set: sorted unique ids, then
    sentinel pads, into a random 100,001 x 128 fp32 table): both scatters
    equal to ``index_add_`` and the gather equal to ``index_select``,
    exactly."""
    table = torch.from_numpy(
        rng.standard_normal((V + 1, D)).astype(np.float32)).to(dev)
    checks = 0
    for ids, live in sets:
        d = rng.standard_normal((len(ids), D)).astype(np.float32)
        d[live:] = 0  # sentinel pads carry zero deltas
        ids_t = torch.from_numpy(ids).to(dev)
        d_t = torch.from_numpy(d).to(dev)
        want = rows.scatter_add_rows_plain(table.clone(), ids_t, d_t)
        for k in (rows.scatter_add_rows_coalesced, rows.scatter_add_rows):
            got = k(table.clone(), ids_t, d_t)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{k.__name__} at the word2vec push shape (bucket "
                    f"{len(ids)}, {live} live): max |kernel - index_add_| = "
                    f"{(got - want).abs().max().item()}")
            checks += 1
            del got
        g = rows.gather_rows(table, ids_t)
        if not torch.equal(g, rows.gather_rows_plain(table, ids_t)):
            raise AssertionError(f"gather_rows at the word2vec pull shape "
                                 f"(bucket {len(ids)}) != index_select")
        checks += 1
    print(f"word2vec push shape ({V + 1} x {D} fp32, bucket {len(sets[0][0])}, "
          f"{len(sets)} id sets): coalesced and simple scatter equal to "
          f"index_add_, gather equal to index_select ({checks} checks)",
          flush=True)
    del table


def time_scatters(rows, table, id_sets, n_live: int, dev, rng, iters: int = 200):
    """CUDA-event ms per call of the coalesced and simple scatters and of
    index_add_, with the id sets in rotation, beside the bytes bound:
    ids and deltas read, each live row (and the sentinel) read and written
    once."""
    B, C = id_sets[0].shape[0], table.shape[1]
    deltas = torch.from_numpy(
        rng.standard_normal((B, C)).astype(np.float32)).to(dev)
    it = iter(range(1 << 62))

    def ids():
        return id_sets[next(it) % len(id_sets)]

    row_bytes = C * table.element_size()
    t_bytes = (4 * B + B * row_bytes + 2 * (n_live + 1) * row_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_live * C / FP32_OPS_PER_S * 1e3
    out = {
        "coalesced_ms": device_ms(lambda: rows.scatter_add_rows_coalesced(table, ids(), deltas), iters),
        "plain_ms": device_ms(lambda: rows.scatter_add_rows_coalesced_plain(table, ids(), deltas), iters),
        "simple_ms": device_ms(lambda: rows.scatter_add_rows(table, ids(), deltas), iters),
        "index_add_ms": device_ms(lambda: table.index_add_(0, ids(), deltas), iters),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    return out


def time_gather(rows, table, id_sets, n_live: int, iters: int = 200):
    """CUDA-event ms per call of the gather, its plain version and
    ``index_select``, with the id sets in rotation, beside the bytes bound:
    ids read, each live row (and the sentinel) read once, the output
    written once."""
    B, C = id_sets[0].shape[0], table.shape[1]
    it = iter(range(1 << 62))

    def ids():
        return id_sets[next(it) % len(id_sets)]

    row_bytes = C * table.element_size()
    return {
        "gather_ms": device_ms(lambda: rows.gather_rows(table, ids()), iters),
        "plain_ms": device_ms(lambda: rows.gather_rows_plain(table, ids()), iters),
        "index_select_ms": device_ms(lambda: table.index_select(0, ids()), iters),
        "bound_ms": (4 * B + (n_live + 1) * row_bytes + B * row_bytes)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def adagrad_mirror(mirror, g_sqr, ids, vals, lr, rho):
    """The AdaGrad row update on the host in float32, duplicates summed
    first: g += d*d; data -= lr*d/sqrt(g + rho)."""
    uniq, inv = np.unique(ids, return_inverse=True)
    d = np.zeros((len(uniq), vals.shape[1]), np.float32)
    np.add.at(d, inv, vals)
    g = g_sqr[uniq] + d * d
    g_sqr[uniq] = g
    mirror[uniq] -= np.float32(lr) * d / np.sqrt(g + np.float32(rho))


def ps_tables(mvt, num_row: int, num_col: int) -> list:
    """The PS phase's tables, in creation order (a restart re-creates them
    in this order, so their ids match a snapshot's): the default-updater
    matrix, the AdaGrad matrix and the array table."""
    return [mvt.create_table("matrix", num_row, num_col),
            mvt.create_table("matrix", num_row, num_col, updater_type="adagrad"),
            mvt.create_table("array", num_row)]


def ps_phase(mvt, rows, device: str, rounds: int, num_row: int = ROWS,
             num_col: int = COLS, batch: int = BATCH, seed: int = 0,
             snapshot=None):
    """Drive the parameter server through its user entry points and check
    every table against a host mirror. Returns the end-to-end metrics and
    the kernels' launch counts over the drive. ``snapshot(tables)``, when
    given, runs on the checked tables before the runtime stops."""
    from multiverso_tpu_torch.dashboard import Dashboard

    mvt.init(device=device, local_workers=WORKERS)
    try:
        mat, ada, arr = ps_tables(mvt, num_row, num_col)
        arr_size = num_row
        opt = mvt.AddOption(learning_rate=0.1, rho=0.1)
        lat = {w: {"add": [], "get": []} for w in range(WORKERS)}
        errors = []
        go = threading.Barrier(WORKERS + 1)

        def batches(w, n):
            rng = np.random.default_rng([seed, w])
            for _ in range(n):
                yield (rng.integers(0, num_row, batch).astype(np.int32),
                       rng.standard_normal((batch, num_col), dtype=np.float32))

        def matrix_worker(w):
            try:
                with mvt.worker(w):
                    gids_rng = np.random.default_rng([seed, w, 1])
                    go.wait()
                    for ids, vals in batches(w, rounds):
                        t0 = time.perf_counter()
                        mat.add(vals, row_ids=ids)
                        t1 = time.perf_counter()
                        got = mat.get(gids_rng.integers(0, num_row, batch))
                        t2 = time.perf_counter()
                        lat[w]["add"].append(t1 - t0)
                        lat[w]["get"].append(t2 - t1)
                        if got.shape != (batch, num_col) or not np.isfinite(got).all():
                            raise AssertionError(f"bad Get reply {got.shape}")
            except BaseException as exc:  # reported by the main thread
                errors.append(exc)

        def other_worker(w):
            try:
                with mvt.worker(w):
                    for k, (ids, vals) in enumerate(batches(w, rounds // 4)):
                        ada.add(vals, row_ids=ids, option=mvt.AddOption(
                            worker_id=w, learning_rate=opt.learning_rate,
                            rho=opt.rho))
                        arr.add(np.full(arr_size, w + k, np.float32))
            except BaseException as exc:
                errors.append(exc)

        def join(threads):
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads):
                raise TimeoutError("worker threads did not finish")
            if errors:
                raise errors[0]

        rows.scatter_add_rows.launches = 0
        rows.gather_rows.launches = 0
        Dashboard.reset()
        threads = [threading.Thread(target=matrix_worker, args=(w,))
                   for w in range(WORKERS)]
        for t in threads:
            t.start()
        go.wait()
        t0 = time.perf_counter()
        join(threads)
        wall = time.perf_counter() - t0
        threads = [threading.Thread(target=other_worker, args=(w,))
                   for w in range(WORKERS)]
        for t in threads:
            t.start()
        join(threads)
        launches = {"scatter_add_rows": rows.scatter_add_rows.launches,
                    "gather_rows": rows.gather_rows.launches}
        fused = Dashboard.counter_value("APPLY_FUSED_CALLS")
        batched = Dashboard.counter_value("APPLY_BATCHED_MSGS")
        # where the time went: worker-side sync calls against the
        # dispatcher-side applies (host clock, whole drive)
        print(Dashboard.render(), flush=True)

        # host mirrors of every Add, rebuilt from the same seeds
        mirror = np.zeros((num_row, num_col), np.float64)
        ada_mirror = np.zeros((num_row, num_col), np.float32)
        for w in range(WORKERS):
            for ids, vals in batches(w, rounds):
                np.add.at(mirror, ids, vals)
            g_sqr = np.zeros((num_row, num_col), np.float32)
            for ids, vals in batches(w, rounds // 4):
                adagrad_mirror(ada_mirror, g_sqr, ids, vals, opt.learning_rate,
                               opt.rho)
            del g_sqr
        arr_mirror = np.full(arr_size, sum(w + k for w in range(WORKERS)
                                           for k in range(rounds // 4)), np.float32)
        for name, table, want in (("matrix", mat, mirror),
                                  ("adagrad matrix", ada, ada_mirror),
                                  ("array", arr, arr_mirror)):
            got = table.get()
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"{name} table: shape {got.shape} or non-finite")
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} table != host mirror")
        adds = [x for w in lat for x in lat[w]["add"]]
        gets = [x for w in lat for x in lat[w]["get"]]
        metrics = {
            "matrix_adds": len(adds), "matrix_gets": len(gets),
            "adds_per_s": len(adds) / wall,
            "add_p50_us": float(np.percentile(adds, 50) * 1e6),
            "add_p99_us": float(np.percentile(adds, 99) * 1e6),
            "get_p50_us": float(np.percentile(gets, 50) * 1e6),
            "get_p99_us": float(np.percentile(gets, 99) * 1e6),
            "fused_applies": fused, "fused_adds": batched,
            "seconds": wall,
        }
        if snapshot is not None:
            snapshot([mat, ada, arr])
        return metrics, launches
    finally:
        mvt.shutdown()


def api_phase(mvt, device: str = "cuda") -> int:
    """The table API's other paths on the card, each held against numpy
    exactly: whole-table Add/Get, device-resident Add and Get, copies of
    live state, sparse staleness, an int32 table with duplicate ids, and
    the array table's fused device add+get. Returns the number of checks."""
    rng = np.random.default_rng(2)
    checks = 0

    def same(got, want):
        nonlocal checks
        np.testing.assert_array_equal(got, want)
        checks += 1

    mvt.init(device=device, local_workers=1)
    try:
        m = mvt.create_table("matrix", 1000, COLS)
        want = rng.standard_normal((1000, COLS), dtype=np.float32)
        m.add(want)
        ids = np.array([5, 7, 999], np.int32)
        vals = rng.standard_normal((3, COLS), dtype=np.float32)
        m.wait(m.add_device_async(torch.from_numpy(vals).to(device), ids))
        want[ids] += vals
        rows_dev = m.wait_device(m.get_device_async(ids), ids)
        assert rows_dev.device.type == device and rows_dev.shape[0] == 64
        same(rows_dev[:3, :COLS].cpu().numpy(), want[ids])
        same(m.get(), want)
        snap = m.get_device()
        m.add(np.ones((2, COLS), np.float32), row_ids=[0, 0])
        same(snap[:1000, :COLS].cpu().numpy(), want[:1000])  # a copy, not a view
        want[0] += 2
        same(m.get([0, 5]), want[[0, 5]])

        s = mvt.create_table("matrix", 100, COLS, is_sparse=True)
        s.add(np.ones((100, COLS), np.float32))
        same(s.get(), np.ones((100, COLS), np.float32))
        s.add(np.full((2, COLS), 3, np.float32), row_ids=[1, 3])
        same(np.nonzero(~s._server_table._up_to_date[0])[0], [1, 3])
        full = np.ones((100, COLS), np.float32)
        full[[1, 3]] = 4
        same(s.get(), full)

        it = mvt.create_table("matrix", 100, 8, np.int32)
        ids = rng.integers(0, 100, 300).astype(np.int32)
        vals = rng.integers(-9, 9, (300, 8)).astype(np.int32)
        it.add(vals, row_ids=ids)
        want_i = np.zeros((100, 8), np.int32)
        np.add.at(want_i, ids, vals)
        same(it.get(), want_i)

        a = mvt.create_table("array", 4096)
        out = a.wait(a.sync_device_async(torch.full((4096,), 2.0, device=device)))
        a.add(np.ones(4096, np.float32))
        same(out.cpu().numpy(), np.full(4096, 2.0, np.float32))  # a copy
        same(a.get(), np.full(4096, 3.0, np.float32))
        return checks
    finally:
        mvt.shutdown()


def numpy_draws(seed: int, window: int, negatives: int):
    """A PSTrainer draw hook from numpy (the same draws on any device)."""
    rng = np.random.default_rng(seed)

    def hook(step, t, tg, pool):
        return {"win": rng.integers(1, window + 1, t),
                "neg": rng.integers(0, pool, (tg, negatives))}

    return hook


def w2v_chunks(config, tokens: int) -> int:
    """Chunk steps one ``PSTrainer`` submission of ``tokens`` tokens runs:
    the chunk layout of ``PSTrainer._submit_block_fast``, restated so that
    the smoke holds the chain's launch counter to it."""
    from multiverso_tpu_torch.utils import next_pow2
    g = config.neg_sharing
    chunk = next_pow2(max(128, config.batch_pairs // max(config.window, 1)))
    chunk = min(chunk, next_pow2(max(tokens, g)))
    if chunk % g:
        chunk *= g
    return next_pow2(-(-tokens // chunk))


def check_sgns_launches(where: str, got: int, chunks: int, device: str) -> int:
    """The chain's launches over a run of ``chunks`` chunk steps: KERNELS
    a chunk on the card, none on the CPU (the plain version)."""
    from multiverso_tpu_torch.ops import sgns
    want = sgns.KERNELS * chunks if device == "cuda" else 0
    if got != want:
        raise AssertionError(f"sgns_chunk over {where}: {got} launches, "
                             f"{want} for {chunks} chunk steps")
    return got


def word2vec_phase(mvt, rows, device: str, card: str, w2v=None,
                   group: int = W2V_GROUP, submissions: int = W2V_SUBMISSIONS,
                   device_blocks: int = W2V_DEVICE_BLOCKS):
    """word2vec on the parameter server and on one device at the bench
    recipe's width. Returns (metrics, the kernels' launch counts over the
    phase). ``device="cpu"`` with a small ``w2v`` rehearses the phase on
    the host."""
    from multiverso_tpu_torch import convert
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.models.vocab import Dictionary
    from multiverso_tpu_torch.models.word2vec import (
        DeviceTrainer, PSTrainer, Word2VecConfig, init_params,
        make_corpus_train_step)
    from multiverso_tpu_torch.ops import sgns

    w2v = dict(W2V, **(w2v or {}))
    config = Word2VecConfig(**w2v)
    V, T = config.vocab_size, config.block_tokens
    d = Dictionary()
    d.words = [f"w{i}" for i in range(V)]
    d.counts = w2v_counts(V)
    rng = np.random.default_rng(0)
    blocks = [zipf_tokens(rng, T, V) for _ in range(group * submissions)]
    init = init_params(config, device="cpu")  # numpy draws from config.seed
    w_in0 = init["w_in"][:V].numpy()
    w_out0 = init["w_out"][:V].numpy()
    metrics = {}

    def trainer(dev):
        mvt.init(device=dev, local_workers=1)
        tr = PSTrainer(config, d)
        convert.load_state(tr.input_table, w_in0, {})
        convert.load_state(tr.output_table, w_out0, {})
        return tr

    def one_submission(dev, coalesce: bool):
        rows.COALESCE = coalesce
        tr = trainer(dev)
        try:
            tr.draw_hook = numpy_draws(7, config.window, config.negatives)
            loss = tr.train_block(blocks[0])
            return tr.input_table.get(), tr.output_table.get(), loss
        finally:
            rows.COALESCE = False
            mvt.shutdown()

    def train(coalesce: bool, deterministic: bool):
        rows.COALESCE = coalesce
        torch.use_deterministic_algorithms(deterministic)
        tr = trainer(device)
        try:
            Dashboard.reset()
            t0 = time.perf_counter()
            tr.train(blocks, group=group, log_every_s=1e9)
            wall = time.perf_counter() - t0  # train() ends on a stats read
            txn = Dashboard.get("SERVER_PROCESS_TRANSACT")
            return (tr.input_table.get(), tr.output_table.get(),
                    tr.words_trained / wall, wall * 1e3 / submissions,
                    txn.elapse_ms / max(txn.count, 1))
        finally:
            rows.COALESCE = False
            torch.use_deterministic_algorithms(False)
            mvt.shutdown()

    def profiled_submission():
        """One group-``group`` submission under torch.profiler, after a
        warm one."""
        tr = trainer(device)
        try:
            tr.train_block(np.concatenate(blocks[:group]))
            return profile(lambda: tr.train_block(
                np.concatenate(blocks[group:2 * group])))
        finally:
            mvt.shutdown()

    for k in (rows.gather_rows, rows.scatter_add_rows,
              rows.scatter_add_rows_coalesced, sgns.sgns_chunk):
        k.launches = 0
    # with COALESCE off the pushes take the simple scatter, with it on the
    # coalesced one; the CPU runs the plain versions either way
    for coalesce in (False, True):
        got = one_submission(device, coalesce)
        want = one_submission("cpu", coalesce)
        tag = "coalesced" if coalesce else "simple"
        for name, g, w in zip(("w_in", "w_out"), got[:2], want[:2]):
            np.testing.assert_allclose(
                g, w, rtol=W2V_RTOL, atol=W2V_ATOL,
                err_msg=f"word2vec {name} ({tag} scatter): {device} != cpu")
        np.testing.assert_allclose(got[2], want[2], rtol=W2V_RTOL)
        metrics[f"group1_loss_{tag}"] = float(got[2])
        metrics[f"group1_max_abs_diff_vs_cpu_{tag}"] = diff = max(
            float(np.abs(g - w).max()) for g, w in zip(got[:2], want[:2]))
        print(f"word2vec group-1 submission on {device} with the {tag} "
              f"scatter equals the CPU's (rtol {W2V_RTOL}, atol {W2V_ATOL}; "
              f"max |diff| {diff}) ({card})", flush=True)

    # as a user runs it, COALESCE off and on in turns (off, on, on, off),
    # then off and on in deterministic mode (index_add_ sorts instead of
    # using atomics); every run from the same start
    turns = [("default", False, False), ("default_coalesced", True, False),
             ("default_coalesced", True, False), ("default", False, False),
             ("deterministic", False, True),
             ("deterministic_coalesced", True, True)]
    runs = {}
    for label, coalesce, deterministic in turns:
        runs.setdefault(label, []).append(train(coalesce, deterministic))
    simple = runs["deterministic"][0]
    coalesced = runs["deterministic_coalesced"][0]
    for name, a, b in zip(("w_in", "w_out"), simple[:2], coalesced[:2]):
        np.testing.assert_array_equal(b, a, err_msg=f"word2vec {name}: "
                                      "COALESCE on != off (deterministic)")
    for label, results in runs.items():
        for r in results:
            if not (np.isfinite(r[0]).all() and np.isfinite(r[1]).all()):
                raise AssertionError(f"word2vec {label}: non-finite tables")
        metrics[f"ps_words_per_s_{label}"] = [r[2] for r in results]
        metrics[f"ps_submission_ms_{label}"] = [r[3] for r in results]
        metrics[f"ps_transaction_ms_{label}"] = [r[4] for r in results]
    metrics["ps_tokens"] = len(blocks) * T
    metrics["ps_submissions"] = submissions
    # what the atomics' order alone does to the weights over the run
    metrics["ps_max_abs_diff_atomics_vs_deterministic"] = max(
        float(np.abs(a - b).max())
        for a, b in zip(runs["default"][0][:2], simple[:2]))
    launches = {k.__name__: k.launches for k in (
        rows.gather_rows, rows.scatter_add_rows, rows.scatter_add_rows_coalesced)}
    # the chain on the card's submissions: two of one block, then the runs'
    launches["sgns_chunk"] = check_sgns_launches(
        "the PS submissions", sgns.sgns_chunk.launches,
        2 * w2v_chunks(config, T)
        + len(turns) * submissions * w2v_chunks(config, group * T), device)

    # the tables-free twin: the corpus step over device_blocks blocks, a
    # chunk a block; run three times (warm, timed, profiled)
    sgns.sgns_chunk.launches = 0
    dt = DeviceTrainer(config, d, device=device)
    step = make_corpus_train_step(config, d, device=dt.device)
    stack = torch.from_numpy(np.stack(blocks[:device_blocks])).to(dt.device)
    step(dt.params, dt.generator, stack, config.lr)  # warm
    if dt.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    dt.params, loss = step(dt.params, dt.generator, stack, config.lr)
    loss = float(loss)  # a device-to-host read: the step has finished
    wall = time.perf_counter() - t0
    if not (np.isfinite(loss) and torch.isfinite(dt.params["w_in"]).all()):
        raise AssertionError(f"DeviceTrainer corpus step diverged (loss {loss})")
    metrics["device_words_per_s"] = device_blocks * T / wall
    metrics["device_loss"] = loss
    metrics["device_profile"] = profile(
        lambda: float(step(dt.params, dt.generator, stack, config.lr)[1]))
    launches["sgns_chunk_corpus_step"] = check_sgns_launches(
        "the corpus step", sgns.sgns_chunk.launches, 3 * device_blocks, device)
    del dt, step, stack
    if submissions > 1:
        sgns.sgns_chunk.launches = 0
        metrics["ps_profile"] = profiled_submission()
        launches["sgns_chunk_profiled_submissions"] = check_sgns_launches(
            "the profiled submissions", sgns.sgns_chunk.launches,
            2 * w2v_chunks(config, group * T), device)
    return metrics, launches


def profile(fn, top: int = 6):
    """Host wall time of ``fn`` under torch.profiler, the card's busy time
    over it (the union of the device spans, kernels and copies, that the
    trace records from every thread) and the kernels that took most of
    it. On the CPU there is no device time."""
    from torch._C._profiler import _ExperimentalConfig
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0) or 0.0

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy_ms = busy_us / 1e3
    # kernels only: an operator launched from a traced thread carries its
    # kernels' time as well
    avgs = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3
                               for e in avgs[:top] if dev_us(e) > 0}}


def join_workers(n: int, fn, timeout: float = JOIN_S) -> None:
    """Run ``fn(slot)`` on n threads; fail, never hang, if one is still
    running after ``timeout`` seconds, and re-raise the first error."""
    errors = []

    def guarded(slot):
        try:
            fn(slot)
        except BaseException as exc:  # reported by the calling thread
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=(s,), daemon=True)
               for s in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"worker threads still running after {timeout} s")
    if errors:
        raise errors[0]


def stop_runtime(mvt) -> None:
    """Shut the port down and reset its flags: they stay set across
    ``shutdown``, and a later bare ``init`` would inherit a gated server."""
    from multiverso_tpu_torch.config import FLAGS
    mvt.shutdown()
    FLAGS.reset()


def mode_batches(seed: int, w: int, rounds: int, num_row: int, num_col: int,
                 batch: int):
    """Worker ``w``'s rounds: (Add ids, Add values, Get ids). Each Add puts
    1.0 on the worker's counter row ``w`` and random normal values on
    random rows (duplicates included) past the counter rows; each Get
    reads every counter row, then random rows."""
    rng = np.random.default_rng([seed, w, 2])
    for _ in range(rounds):
        ids = np.concatenate([[w], rng.integers(WORKERS, num_row, batch - 1)])
        vals = rng.standard_normal((batch, num_col), dtype=np.float32)
        vals[0] = 1.0
        gids = np.concatenate([np.arange(WORKERS),
                               rng.integers(0, num_row, batch - WORKERS)])
        yield ids.astype(np.int32), vals, gids.astype(np.int32)


def modes_phase(mvt, rows, device: str, mode: str, rounds: int = MODE_ROUNDS,
                num_row: int = ROWS, num_col: int = COLS, batch: int = BATCH,
                jitter_s: float = 0.0, seed: int = 0):
    """Four worker threads under one consistency server (``MODES[mode]``),
    each round one 1024-row Add and then one 1024-row Get on a default
    matrix table; each worker ends with ``finish_train``. Checks every Get's
    counter rows against the server's contract and, under BSP, every Get
    against the host mirror after exactly its round. Returns (metrics, the
    final table, the kernels' launch counts over the drive)."""
    from multiverso_tpu_torch.dashboard import Dashboard

    mvt.init(device=device, local_workers=WORKERS, **MODES[mode])
    try:
        server = mvt.Zoo.instance().server
        table = mvt.create_table("matrix", num_row, num_col)
        gets, lat = {}, {"add": [], "get": []}

        def work(w):
            sleep = np.random.default_rng([seed, w, 3]).uniform(0, jitter_s, rounds)
            with mvt.worker(w):
                for r, (ids, vals, gids) in enumerate(
                        mode_batches(seed, w, rounds, num_row, num_col, batch)):
                    if jitter_s:
                        time.sleep(sleep[r])
                    t0 = time.perf_counter()
                    table.add(vals, row_ids=ids)
                    t1 = time.perf_counter()
                    gets[(w, r)] = table.get(gids)
                    lat["add"].append(t1 - t0)
                    lat["get"].append(time.perf_counter() - t1)
                table.finish_train()

        for k in (rows.gather_rows, rows.scatter_add_rows):
            k.launches = 0
        Dashboard.reset()
        t0 = time.perf_counter()
        join_workers(WORKERS, work)
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches
                    for k in (rows.gather_rows, rows.scatter_add_rows)}
        with mvt.Zoo.instance().admin():  # past every round, outside the clocks
            final = table.get()
        clocks = ([list(server._add_clock[table.table_id]),
                   list(server._get_clock[table.table_id])]
                  if hasattr(server, "_add_clock") else None)
        gate = Dashboard.histogram("SYNC_GATE_WAIT_SECONDS")
        stale = {w: Dashboard.gauge(f"SSP_STALENESS_W{w}").value
                 for w in range(WORKERS)} if mode == "ssp2" else None
    finally:
        stop_runtime(mvt)

    # the contract, on the counter rows of every Get
    lag = 0
    for (w, r), got in gets.items():
        if got.shape != (batch, num_col) or not np.isfinite(got).all():
            raise AssertionError(f"{mode}: bad Get reply {got.shape}")
        seen = got[:WORKERS, 0]
        if mode == "bsp":
            ok = (seen == r + 1).all()
        elif mode == "ssp2":
            ok = seen[w] == r + 1 and (seen >= r + 1 - 2).all() and (seen <= rounds).all()
        else:
            ok = ((seen >= 0) & (seen <= rounds) & (seen == np.round(seen))).all()
        if not ok or not (got[:WORKERS] == got[:WORKERS, :1]).all():
            raise AssertionError(f"{mode}: worker {w}'s round-{r + 1} Get read "
                                 f"counter rows {seen.tolist()}")
        lag = max(lag, int(r + 1 - seen.min()))
    # the host mirror, round by round; under BSP each Get equals it
    mirror = np.zeros((num_row, num_col), np.float64)
    per_worker = [list(mode_batches(seed, w, rounds, num_row, num_col, batch))
                  for w in range(WORKERS)]
    for r in range(rounds):
        for w in range(WORKERS):
            ids, vals, _ = per_worker[w][r]
            np.add.at(mirror, ids, vals)
        if mode == "bsp":
            for w in range(WORKERS):
                gids = per_worker[w][r][2]
                np.testing.assert_allclose(
                    gets[(w, r)], mirror[gids], rtol=MODE_RTOL, atol=MODE_ATOL,
                    err_msg=f"bsp: worker {w}'s round-{r + 1} Get != the "
                    f"mirror after {r + 1} rounds")
    if final.shape != mirror.shape or not np.isfinite(final).all():
        raise AssertionError(f"{mode}: final table {final.shape} or non-finite")
    if mode != "deterministic":
        np.testing.assert_allclose(final, mirror, rtol=MODE_RTOL, atol=MODE_ATOL,
                                   err_msg=f"{mode}: final table != host mirror")
    max_diff = float(np.abs(final - mirror).max())
    adds = lat["add"]
    metrics = {
        "adds": len(adds), "gets": len(lat["get"]), "seconds": wall,
        "adds_per_s": len(adds) / wall,
        "add_p50_us": float(np.percentile(adds, 50) * 1e6),
        "add_p99_us": float(np.percentile(adds, 99) * 1e6),
        "get_p50_us": float(np.percentile(lat["get"], 50) * 1e6),
        "get_p99_us": float(np.percentile(lat["get"], 99) * 1e6),
        "gate_waits": gate.count, "gate_wait_p50_ms": gate.p50 * 1e3,
        "gate_wait_max_ms": gate.max * 1e3,
        "max_rounds_behind_read": lag, "clocks": clocks,
        "ssp_staleness_gauges": stale,
        "max_abs_diff_vs_mirror": max_diff,
    }
    return metrics, final, launches


def open_rounds(trainer) -> None:
    """BSP serves a worker's i-th Get after every worker's i-th Add: open
    the first round of both word2vec tables with a zero Add (call from
    each worker's context before it trains)."""
    for table in (trainer.input_table, trainer.output_table):
        table.add(np.zeros((1, table.num_col), np.float32), row_ids=[0])


def staged_word2vec_phase(mvt, rows, device: str, card: str, w2v=None,
                          blocks_per_worker: int = STAGED_BLOCKS):
    """``PSTrainer.train_block`` on the staged path (the gated and
    deterministic servers refuse the fused transaction) at the bench
    recipe's width, from ``mvt.worker`` threads each followed by
    ``finish_train``. Returns (metrics, the kernels' launch counts over the
    card's runs)."""
    from multiverso_tpu_torch import convert
    from multiverso_tpu_torch.models.vocab import Dictionary
    from multiverso_tpu_torch.models.word2vec import (PSTrainer, Word2VecConfig,
                                                      init_params)
    from multiverso_tpu_torch.ops import sgns

    config = Word2VecConfig(**dict(W2V, **(w2v or {})))
    V, T = config.vocab_size, config.block_tokens
    d = Dictionary()
    d.words = [f"w{i}" for i in range(V)]
    d.counts = w2v_counts(V)
    rng = np.random.default_rng(4)
    blocks = [zipf_tokens(rng, T, V) for _ in range(2 * blocks_per_worker)]
    init = init_params(config, device="cpu")
    w_in0, w_out0 = init["w_in"][:V].numpy(), init["w_out"][:V].numpy()

    def run(dev, mode, workers, per_worker):
        flags = MODES[mode]
        mvt.init(device=dev, local_workers=workers, **flags)
        try:
            tr = PSTrainer(config, d)
            if tr._can_transact():
                raise AssertionError(f"{mode}: the fused transaction was "
                                     "admitted under a gated server")
            convert.load_state(tr.input_table, w_in0, {})
            convert.load_state(tr.output_table, w_out0, {})
            tr.draw_hook = numpy_draws(11, config.window, config.negatives)
            if flags.get("sync"):
                for slot in range(workers):
                    with mvt.worker(slot):
                        open_rounds(tr)
            losses = []

            def work(slot):
                with mvt.worker(slot):
                    for b in blocks[slot::workers][:per_worker]:
                        losses.append(tr.train_block(b))
                    tr.input_table.finish_train()
                    tr.output_table.finish_train()

            t0 = time.perf_counter()
            join_workers(workers, work)
            wall = time.perf_counter() - t0  # train_block ends on a stats read
            with mvt.Zoo.instance().admin():
                w_in, w_out = tr.input_table.get(), tr.output_table.get()
                words = int(tr.count_table.get(0))
            if words != workers * per_worker * T:
                raise AssertionError(f"{mode}: word count {words}")
            if not (np.isfinite(w_in).all() and np.isfinite(w_out).all()
                    and np.isfinite(losses).all()):
                raise AssertionError(f"{mode}: non-finite tables or loss")
            return w_in, w_out, losses, words / wall
        finally:
            stop_runtime(mvt)

    metrics = {}
    # BSP, one worker: the card against the CPU over two blocks, same draws
    got = run(device, "bsp", 1, 2)
    want = run("cpu", "bsp", 1, 2)
    for name, g, w in zip(("w_in", "w_out"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=W2V_RTOL, atol=W2V_ATOL,
                                   err_msg=f"staged word2vec {name} under "
                                   f"-sync: {device} != cpu")
    np.testing.assert_allclose(got[2], want[2], rtol=W2V_RTOL)
    metrics["bsp_max_abs_diff_vs_cpu"] = diff = max(
        float(np.abs(g - w).max()) for g, w in zip(got[:2], want[:2]))
    print(f"staged word2vec under -sync, 2 blocks on {device} equal the CPU's "
          f"(rtol {W2V_RTOL}, atol {W2V_ATOL}; max |diff| {diff}) ({card})",
          flush=True)

    for k in (rows.gather_rows, rows.scatter_add_rows, sgns.sgns_chunk):
        k.launches = 0
    bsp = run(device, "bsp", 1, blocks_per_worker)
    ssp = run(device, "ssp2", 2, blocks_per_worker)
    det = [run(device, "deterministic", 1, blocks_per_worker) for _ in range(2)]
    launches = {k.__name__: k.launches for k in (rows.gather_rows, rows.scatter_add_rows)}
    # a block a submission: one worker, two, then one twice
    launches["sgns_chunk"] = check_sgns_launches(
        "the staged runs", sgns.sgns_chunk.launches,
        5 * blocks_per_worker * w2v_chunks(config, T), device)
    metrics.update({
        "bsp_1worker_words_per_s": bsp[3], "bsp_losses": bsp[2],
        "ssp2_2workers_words_per_s": ssp[3],
        "deterministic_words_per_s": [r[3] for r in det],
        # the step sums duplicate rows in index order under the flag
        # (index_put_ with accumulate); the two runs must be bitwise equal
        "deterministic_drift_max_abs": max(
            float(np.abs(a - b).max()) for a, b in zip(det[0][:2], det[1][:2])),
        "deterministic_bitwise_equal": all(
            np.array_equal(a, b) for a, b in zip(det[0][:2], det[1][:2])),
        "tokens_per_worker": blocks_per_worker * T,
    })
    if not metrics["deterministic_bitwise_equal"]:
        raise AssertionError(
            f"staged word2vec under -deterministic: two runs differ (max "
            f"|diff| {metrics['deterministic_drift_max_abs']})")
    return metrics, launches


def ctr_data(rng, n: int, key_space: int = CTR_KEYS, fields: int = CTR_FIELDS):
    """Synthetic click logs in the shape of the Criteo data: one active
    feature per field (zipf-distributed values hashed with the field into
    ``key_space``), value 1.0, labels drawn from a hidden logistic model of
    the keys."""
    values = np.minimum(rng.zipf(1.3, (n, fields)), 1 << 20).astype(np.int64)
    keys = (values * 2654435761 + np.arange(fields) * 97_531) % key_space
    hidden = ((keys * 2246822519) % 2001) / 1000.0 - 1.0
    p = 1.0 / (1.0 + np.exp(-2.0 * hidden.sum(axis=1) / np.sqrt(fields)))
    return {"idx": keys.astype(np.int32),
            "val": np.ones((n, fields), np.float32),
            "y": (rng.random(n) < p).astype(np.int32)}


def digits_data(rng, n: int, features: int = MNIST_FEATURES, classes: int = 10):
    """Synthetic 28 x 28 digits: a noisy copy of one of ten templates."""
    templates = rng.random((classes, features), dtype=np.float32)
    y = rng.integers(0, classes, n)
    x = np.clip(templates[y] + 0.3 * rng.standard_normal((n, features)), 0, 1)
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def logreg_runs(ctr_keys: int = CTR_KEYS, features: int = MNIST_FEATURES):
    """The four table choices of ``PSLogReg``: (config, data kind)."""
    from multiverso_tpu_torch.models.logreg import LogRegConfig
    ctr = dict(input_size=ctr_keys, sparse=True, max_nnz=CTR_FIELDS, use_ps=True)
    ftrl = dict(alpha=0.5, lambda1=0.5)  # examples/ftrl_ctr.py
    # 784 dense features in [0, 1] move every coordinate at once: the
    # sparse example's step makes the dense model diverge
    dense_ftrl = dict(alpha=0.02, lambda1=0.5)
    return {
        "ctr_sparse_sgd": (LogRegConfig(objective="sigmoid", lr=0.1, **ctr), "ctr"),
        "ctr_sparse_ftrl": (LogRegConfig(objective="ftrl", sync_frequency=4,
                                         pipeline=True, **ctr, **ftrl), "ctr"),
        "mnist_array_softmax": (LogRegConfig(
            input_size=features, output_size=10, objective="softmax", lr=0.1,
            use_ps=True), "digits"),
        "mnist_ftrl_binary": (LogRegConfig(
            input_size=features, objective="ftrl", use_ps=True,
            sync_frequency=4, pipeline=True, **dense_ftrl), "binary"),
    }


def logreg_phase(mvt, rows, device: str, card: str, batches: int = LR_BATCHES,
                 ctr_keys: int = CTR_KEYS, features: int = MNIST_FEATURES):
    """``PSLogReg`` through each table choice: one minibatch on the card
    against the CPU, then ``batches`` minibatches timed on the card.
    Returns (metrics, the kernels' launch counts over the card's runs)."""
    from multiverso_tpu_torch.models.logreg import PSLogReg, minibatches

    rng = np.random.default_rng(6)
    n = batches * 256
    digits = digits_data(rng, n, features)
    data = {"ctr": ctr_data(rng, n, ctr_keys),
            "digits": digits,
            "binary": {"x": digits["x"], "y": (digits["y"] >= 5).astype(np.int32)}}

    def run(dev, config, kind, n_batches):
        mvt.init(device=dev, local_workers=1)
        try:
            model = PSLogReg(config)
            mbs = list(minibatches(data[kind], config.minibatch))[:n_batches]
            t0 = time.perf_counter()
            losses = [model.update(b) for b in mbs]
            model.finish()
            wall = time.perf_counter() - t0
            return model.weights(), losses, len(mbs) * config.minibatch / wall
        finally:
            stop_runtime(mvt)

    metrics = {}
    for k in (rows.gather_rows, rows.scatter_add_rows):
        k.launches = 0
    for name, (config, kind) in logreg_runs(ctr_keys, features).items():
        got, want = run(device, config, kind, 1), run("cpu", config, kind, 1)
        np.testing.assert_allclose(got[0], want[0], rtol=LR_RTOL, atol=LR_ATOL,
                                   err_msg=f"logreg {name}: {device} != cpu")
        np.testing.assert_allclose(got[1], want[1], rtol=LR_RTOL)
        w, losses, ex_s = run(device, config, kind, batches)
        if not (np.isfinite(w).all() and np.isfinite(losses).all()):
            raise AssertionError(f"logreg {name}: non-finite weights or loss")
        metrics[name] = {
            "max_abs_diff_vs_cpu": float(np.abs(got[0] - want[0]).max()),
            "examples_per_s": ex_s, "first_loss": losses[0],
            "last_loss": losses[-1], "minibatches": len(losses)}
    launches = {k.__name__: k.launches for k in (rows.gather_rows, rows.scatter_add_rows)}
    return metrics, launches


# -- checkpoints -------------------------------------------------------------

def host_state(tables) -> list:
    """Each table's state as host numpy arrays at logical dims (data, then
    updater states or accumulators by name; host-dict tables as sorted
    keys and their rows), read on the dispatcher after every queued Add."""
    from multiverso_tpu_torch.runtime.zoo import Zoo
    from multiverso_tpu_torch.tables.array_table import ArrayServer
    from multiverso_tpu_torch.tables.ftrl_table import FTRLServer
    from multiverso_tpu_torch.tables.kv_table import KVServer
    from multiverso_tpu_torch.tables.matrix_table import MatrixServer
    from multiverso_tpu_torch.tables.sparse_table import (SparseFTRLServer,
                                                          SparseServer)

    def read():
        out = []
        for t in tables:
            s = t._server_table
            if isinstance(s, (MatrixServer, ArrayServer)):
                logical = ((slice(0, s.num_row), slice(0, s.num_col))
                           if isinstance(s, MatrixServer) else (slice(0, s.size),))
                out.append([s._host_read(s.data[logical])] + [
                    s._host_read(s.states[k][(slice(None),) + logical])
                    for k in sorted(s.states)])
            elif isinstance(s, FTRLServer):
                out.append([s._host_read(s.z[: s.size]),
                            s._host_read(s.n[: s.size])])
            elif isinstance(s, SparseFTRLServer):
                keys = sorted(s._z)
                out.append([np.array(keys, np.int64)] + [
                    np.stack([acc[k] for k in keys]) if keys
                    else np.zeros((0, s.width), np.float32)
                    for acc in (s._z, s._n)])
            elif isinstance(s, SparseServer):
                out.append(list(s.process_get((None, None))))
            elif isinstance(s, KVServer):
                items = sorted(s._store.items())
                out.append([np.array([k for k, _ in items], np.int64),
                            np.array([v for _, v in items], s.value_dtype)])
            else:
                raise TypeError(f"host_state: {type(s).__name__}")
        return out

    return Zoo.instance().server.run_serialized(read, timeout=None)


def assert_same_state(got, want, what: str) -> None:
    """Bitwise equality of two ``host_state`` results (dtype, shape, bits)."""
    for i, (g_arrs, w_arrs) in enumerate(zip(got, want, strict=True)):
        for j, (g, w) in enumerate(zip(g_arrs, w_arrs, strict=True)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{what}: table {i} array {j}: {g.dtype}"
                                     f"{g.shape} != {w.dtype}{w.shape}")
            word = np.dtype(f"u{g.dtype.itemsize}")
            if not np.array_equal(np.ascontiguousarray(g).view(word),
                                  np.ascontiguousarray(w).view(word)):
                raise AssertionError(f"{what}: table {i} array {j} differs")


def snapshot_tables(tables, directory: str) -> dict:
    """Host copies of the tables, then one ``CheckpointDriver`` snapshot
    into ``directory``: the copies, the seconds of the copies (the same
    device-to-host reads the snapshot makes), the bytes written and the
    snapshot's seconds."""
    from multiverso_tpu_torch.checkpoint import CheckpointDriver

    t0 = time.perf_counter()
    before = host_state(tables)
    host_read_s = time.perf_counter() - t0
    driver = CheckpointDriver(tables, directory)
    t0 = time.perf_counter()
    driver.snapshot()
    seconds = time.perf_counter() - t0
    driver.close()
    size = sum(os.path.getsize(os.path.join(directory, f))
               for f in os.listdir(directory) if f.endswith(".mvckpt"))
    return {"before": before, "store_s": seconds, "bytes": size,
            "host_read_s": host_read_s}


def restore_and_check(tables, directory: str, snap: dict, what: str) -> float:
    """``restore_tables`` into freshly created tables, held bitwise against
    the snapshot's host copies; returns the restore's seconds."""
    from multiverso_tpu_torch.checkpoint import restore_tables

    t0 = time.perf_counter()
    n = restore_tables(tables, directory)
    seconds = time.perf_counter() - t0
    if n != len(tables):
        raise AssertionError(f"{what}: restored {n} of {len(tables)} tables")
    assert_same_state(host_state(tables), snap["before"], what)
    return seconds


def io_rates(snap: dict, restore_s: float) -> dict:
    return {"bytes": snap["bytes"], "host_read_s": snap["host_read_s"],
            "store_s": snap["store_s"],
            "store_gb_per_s": snap["bytes"] / snap["store_s"] / 1e9,
            "restore_s": restore_s,
            "restore_gb_per_s": snap["bytes"] / restore_s / 1e9}


def ps_restore(mvt, device: str, directory: str, snap: dict,
               num_row: int = ROWS, num_col: int = COLS) -> dict:
    """Restart the runtime, re-create the PS phase's tables and restore
    its snapshot: data and AdaGrad states bitwise equal to the host copies
    taken before it; the column pads and the sentinel rows zero."""
    mvt.init(device=device, local_workers=WORKERS)
    try:
        tables = ps_tables(mvt, num_row, num_col)
        restore_s = restore_and_check(tables, directory, snap, "PS restore")
        for t in tables[:2]:
            s = t._server_table
            for arr in [s.data] + list(s.states.values()):
                if (arr[..., s.num_row:, :].count_nonzero().item()
                        or arr[..., s.num_col:].count_nonzero().item()):
                    raise AssertionError("PS restore: a pad or the sentinel "
                                         "row is not zero")
        # the restore's share that is reading the files (page cache)
        t0 = time.perf_counter()
        for f in os.listdir(directory):
            with open(os.path.join(directory, f), "rb") as fp:
                fp.read()
        return dict(io_rates(snap, restore_s),
                    file_read_s=time.perf_counter() - t0)
    finally:
        mvt.shutdown()


def resume_phase(mvt, rows, device: str, ckpt_dir: str,
                 rounds: int = RESUME_ROUNDS, num_row: int = ROWS,
                 num_col: int = COLS, batch: int = BATCH, seed: int = 9):
    """Resume exactness on the PS tables with one worker: run A plays 2R
    rounds of a seeded stream (a 1024-row Add to the default and the
    AdaGrad matrix, a 1024-row Get); run B plays R rounds, snapshots,
    restarts, restores and plays the other R. Final data and AdaGrad
    states must be bitwise equal (unique ids after the merge: no atomics).
    Returns (metrics, the kernels' launch counts over run B's resumed
    rounds)."""
    rng = np.random.default_rng(seed)
    stream = [(rng.integers(0, num_row, batch).astype(np.int32),
               rng.standard_normal((batch, num_col), dtype=np.float32),
               rng.integers(0, num_row, batch).astype(np.int32),
               rng.standard_normal((batch, num_col), dtype=np.float32),
               rng.integers(0, num_row, batch).astype(np.int32))
              for _ in range(2 * rounds)]
    opt = mvt.AddOption(worker_id=0, learning_rate=0.1, rho=0.1)

    def start():
        mvt.init(device=device, local_workers=1)
        return [mvt.create_table("matrix", num_row, num_col),
                mvt.create_table("matrix", num_row, num_col, updater_type="adagrad")]

    def play(tables, part) -> float:
        mat, ada = tables
        t0 = time.perf_counter()
        with mvt.worker(0):
            for ids, vals, ada_ids, ada_vals, gids in part:
                mat.add(vals, row_ids=ids)
                ada.add(ada_vals, row_ids=ada_ids, option=opt)
                got = mat.get(gids)
                if got.shape != (batch, num_col) or not np.isfinite(got).all():
                    raise AssertionError(f"resume: bad Get reply {got.shape}")
        return 2 * len(part) / (time.perf_counter() - t0)

    metrics = {"rounds": 2 * rounds}
    tables = start()
    try:
        metrics["uninterrupted_adds_per_s"] = play(tables, stream)
        want = host_state(tables)
    finally:
        mvt.shutdown()
    tables = start()
    try:
        metrics["before_snapshot_adds_per_s"] = play(tables, stream[:rounds])
        snap = snapshot_tables(tables, ckpt_dir)
    finally:
        mvt.shutdown()
    tables = start()
    try:
        restore_s = restore_and_check(tables, ckpt_dir, snap, "resume restore")
        del snap["before"]
        for k in (rows.gather_rows, rows.scatter_add_rows):
            k.launches = 0
        metrics["after_restore_adds_per_s"] = play(tables, stream[rounds:])
        launches = {k.__name__: k.launches
                    for k in (rows.gather_rows, rows.scatter_add_rows)}
        assert_same_state(host_state(tables), want, "resume against uninterrupted")
    finally:
        mvt.shutdown()
    metrics.update(io_rates(snap, restore_s))
    return metrics, launches


def write_corpus(path: str, rng, vocab: int, tokens: int,
                 min_count: int, line_tokens: int = W2V_LINE_TOKENS) -> int:
    """A zipf corpus over ``vocab`` words (the bench's counts) as a text
    file, every word at least ``min_count`` times; returns its tokens."""
    ids = np.concatenate([zipf_tokens(rng, tokens, vocab),
                          np.repeat(np.arange(vocab, dtype=np.int32), min_count)])
    ids = ids[rng.permutation(len(ids))]
    words = np.array([f"w{i}" for i in range(vocab)])[ids]
    with open(path, "w") as fp:
        for i in range(0, len(words), line_tokens):
            fp.write(" ".join(words[i:i + line_tokens].tolist()) + "\n")
    return len(ids)


def word2vec_file_phase(mvt, rows, device: str, card: str, ckpt_dir: str,
                        w2v=None, tokens: int = W2V_FILE_TOKENS,
                        group: int = W2V_GROUP, submissions: int = 4,
                        seed: int = 0):
    """See ``_word2vec_file_phase``; it runs with deterministic algorithms."""
    torch.use_deterministic_algorithms(True)
    try:
        return _word2vec_file_phase(mvt, rows, device, card, ckpt_dir, w2v,
                                    tokens, group, submissions, seed)
    finally:
        torch.use_deterministic_algorithms(False)


def _word2vec_file_phase(mvt, rows, device: str, card: str, ckpt_dir: str,
                         w2v, tokens: int, group: int, submissions: int,
                         seed: int):
    """word2vec from a text file at the bench recipe's width: the corpus
    read by ``Dictionary.from_text_file`` and ``iter_token_blocks``, a
    ``PSTrainer`` trained ``submissions // 2`` group-``group`` submissions,
    snapshotted (tables and the trainer's host RNG), restarted, restored
    bitwise and trained on; held against an uninterrupted run with the
    same injected draws, bitwise and so within rtol W2V_RTOL, atol
    W2V_ATOL. Both runs are deterministic: in the default mode the
    step's ``index_add_`` sums duplicate rows with atomics, whose order
    alone moved one weight of 12.8M by 1.4e-6 (4.5e-4 relative) over two
    submissions on an NVIDIA H100 80GB HBM3. Then the embeddings through
    ``save_embeddings``/``load_embeddings``. Returns (metrics, the
    kernels' launch counts over the resumed submissions)."""
    from multiverso_tpu_torch import convert
    from multiverso_tpu_torch.models.vocab import Dictionary, iter_token_blocks
    from multiverso_tpu_torch.models.word2vec import (PSTrainer, Word2VecConfig,
                                                      init_params, load_embeddings,
                                                      save_embeddings)

    w2v = dict(W2V, **(w2v or {}))
    rng = np.random.default_rng(seed)
    corpus = os.path.join(ckpt_dir, "corpus.txt")
    written = write_corpus(corpus, rng, w2v["vocab_size"], tokens, 5)
    metrics = {"corpus_tokens": written, "corpus_bytes": os.path.getsize(corpus),
               "deterministic_algorithms": True}
    t0 = time.perf_counter()
    d = Dictionary.from_text_file(corpus, min_count=5)
    t1 = time.perf_counter()
    blocks = list(iter_token_blocks(corpus, d, w2v["block_tokens"]))
    t2 = time.perf_counter()
    metrics["dictionary_tokens_per_s"] = written / (t1 - t0)
    metrics["token_blocks_tokens_per_s"] = written / (t2 - t1)
    if len(d) != w2v["vocab_size"] or int(d.counts.sum()) != written:
        raise AssertionError(f"word2vec file: {len(d)} words, "
                             f"{int(d.counts.sum())} tokens counted")
    if sum(len(b) for b in blocks) != written:
        raise AssertionError("word2vec file: blocks lose tokens")
    config = Word2VecConfig(**w2v)
    subs = [np.concatenate(blocks[i * group:(i + 1) * group])
            for i in range(submissions)]
    init = init_params(config, device="cpu")
    V = config.vocab_size
    w_in0, w_out0 = init["w_in"][:V].numpy(), init["w_out"][:V].numpy()

    def trainer():
        mvt.init(device=device, local_workers=1)
        tr = PSTrainer(config, d)
        return tr, [tr.input_table, tr.output_table, tr.count_table]

    def train(tr, part) -> float:
        t0 = time.perf_counter()
        for sub in part:
            loss = tr.train_block(sub, lr=config.lr)  # ends on a stats read
            if not np.isfinite(loss):
                raise AssertionError(f"word2vec file: loss {loss}")
        return sum(len(s) for s in part) / (time.perf_counter() - t0)

    half = submissions // 2
    tr, tables = trainer()
    try:
        convert.load_state(tr.input_table, w_in0, {})
        convert.load_state(tr.output_table, w_out0, {})
        tr.draw_hook = numpy_draws(7, config.window, config.negatives)
        metrics["uninterrupted_words_per_s"] = train(tr, subs)
        want = [t.get() for t in tables[:2]]
    finally:
        mvt.shutdown()
    tr, tables = trainer()
    try:
        convert.load_state(tr.input_table, w_in0, {})
        convert.load_state(tr.output_table, w_out0, {})
        hook = tr.draw_hook = numpy_draws(7, config.window, config.negatives)
        metrics["before_snapshot_words_per_s"] = train(tr, subs[:half])
        snap = snapshot_tables(tables, os.path.join(ckpt_dir, "w2v"))
        host = (tr.rng.bit_generator.state, tr.words_trained)
    finally:
        mvt.shutdown()
    # the trainer's transaction is registered by its constructor, before
    # the restore writes into the tables it closes over
    tr, tables = trainer()
    try:
        restore_s = restore_and_check(tables, os.path.join(ckpt_dir, "w2v"),
                                      snap, "word2vec restore")
        tr.rng.bit_generator.state, tr.words_trained = host
        tr.draw_hook = hook
        for k in (rows.gather_rows, rows.scatter_add_rows):
            k.launches = 0
        metrics["after_restore_words_per_s"] = train(tr, subs[half:])
        launches = {k.__name__: k.launches
                    for k in (rows.gather_rows, rows.scatter_add_rows)}
        got = [t.get() for t in tables[:2]]
        words = int(tr.count_table.get(0))
        emb_path = os.path.join(ckpt_dir, "emb.bin")
        save_embeddings(d, got[0], emb_path, binary=True)
    finally:
        mvt.shutdown()
    if words != sum(len(s) for s in subs):
        raise AssertionError(f"word2vec file: word count {words}")
    for name, g, w in zip(("w_in", "w_out"), got, want):
        np.testing.assert_allclose(g, w, rtol=W2V_RTOL, atol=W2V_ATOL,
                                   err_msg=f"word2vec file: resumed {name} != "
                                   "uninterrupted")
        np.testing.assert_array_equal(g, w, err_msg=f"word2vec file: resumed "
                                      f"{name} not bitwise equal to the "
                                      "uninterrupted run (deterministic)")
    words_read, emb = load_embeddings(emb_path, binary=True)
    again = os.path.join(ckpt_dir, "emb_again.bin")
    save_embeddings(d, emb, again, binary=True)
    with open(emb_path, "rb") as a, open(again, "rb") as b:
        same_bytes = a.read() == b.read()
    if words_read != d.words or not np.array_equal(emb, got[0]) or not same_bytes:
        raise AssertionError("word2vec file: embeddings do not round-trip")
    metrics["embedding_bytes"] = os.path.getsize(emb_path)
    metrics.update(io_rates(snap, restore_s))
    print(f"word2vec from a {metrics['corpus_bytes']}-byte file on {card}: "
          f"read, trained {half} + {submissions - half} group-{group} "
          f"submissions around a restore (bitwise), resumed bitwise equal to "
          f"the uninterrupted run (deterministic algorithms), embeddings "
          f"round-trip byte for byte", flush=True)
    return metrics, launches


def write_lr_files(directory: str, rng, ctr_keys: int, batches: int,
                   dense_batches: int, features: int) -> dict:
    """The CTR libsvm file, a dense binary-digits file and three key=value
    configs as ``examples/logreg_train.py`` reads them. Returns the paths,
    and the CTR data as generated."""
    ctr = ctr_data(rng, batches * 256, ctr_keys)
    ctr_file = os.path.join(directory, "ctr.libsvm")
    with open(ctr_file, "w") as fp:
        for y, keys in zip(ctr["y"], ctr["idx"]):
            fp.write(f"{y} " + " ".join(f"{k}:1" for k in keys) + "\n")
    digits = digits_data(rng, dense_batches * 256, features)
    dense_file = os.path.join(directory, "digits.data")
    with open(dense_file, "w") as fp:
        for y, x in zip(digits["y"] >= 5, digits["x"]):
            fp.write(f"{int(y)} " + " ".join(f"{v:.6g}" for v in x) + "\n")
    common = "use_ps=true\nminibatch_size=256\ntrain_epoch=1\n"
    ctr_conf = (f"input_size={ctr_keys}\nsparse=true\nmax_nnz={CTR_FIELDS}\n"
                f"train_file={ctr_file}\n" + common)
    confs = {
        # examples/ftrl_ctr.py's step on the sparse FTRL table
        "ctr_sparse_ftrl": ctr_conf + ("objective_type=ftrl\nalpha=0.5\n"
                                       "lambda1=0.5\nsync_frequency=4\n"),
        "ctr_sparse_sgd": ctr_conf + ("updater_type=sgd\nlearning_rate=0.1\n"
                                      "pipeline=false\n"),
        "digits_dense_ftrl": (f"input_size={features}\ntrain_file={dense_file}\n"
                              "objective_type=ftrl\nalpha=0.02\nlambda1=0.5\n"
                              "sync_frequency=4\n" + common),
    }
    paths = {}
    for name, text in confs.items():
        paths[name] = os.path.join(directory, f"{name}.conf")
        with open(paths[name], "w") as fp:
            fp.write("# logistic regression, key=value (lr_io.Configure)\n" + text)
    return {"confs": paths, "ctr": ctr, "ctr_file": ctr_file}


def logreg_file_phase(mvt, rows, device: str, card: str, ckpt_dir: str,
                      batches: int = LR_BATCHES, dense_batches: int = 8,
                      ctr_keys: int = CTR_KEYS, features: int = MNIST_FEATURES,
                      seed: int = 12):
    """Logistic regression from config files: ``Configure`` ->
    ``make_reader`` -> ``PSLogReg`` on the sparse FTRL table (the CTR
    file), the sparse table (sgd, the same file) and the dense FTRL table
    (digits), the reader in the loop; its CTR batches equal the generated
    data. Then the three tables snapshotted, the runtime restarted, the
    models re-created and the snapshot restored bitwise. Returns
    (metrics, the kernels' launch counts over the training)."""
    from multiverso_tpu_torch.models.logreg import make_model
    from multiverso_tpu_torch.models.lr_io import Configure, make_reader

    files = write_lr_files(ckpt_dir, np.random.default_rng(seed), ctr_keys,
                           batches, dense_batches, features)
    confs = {name: Configure(path) for name, path in files["confs"].items()}
    ctr = files["ctr"]
    metrics = {}

    def models():
        mvt.init(device=device, local_workers=1)
        return {name: make_model(conf.model_config()) for name, conf in confs.items()}

    built = models()
    try:
        for k in (rows.gather_rows, rows.scatter_add_rows):
            k.launches = 0
        for name, model in built.items():
            conf = confs[name]
            reader = make_reader(conf.reader_type, conf.train_file,
                                 conf.minibatch_size, conf.input_size,
                                 sparse=conf.sparse, max_nnz=conf.max_nnz)
            seen, losses, parts = 0, [], []
            t0 = time.perf_counter()
            try:
                for batch in reader.epochs(conf.train_epoch):
                    if name == "ctr_sparse_ftrl":
                        parts.append({k: batch[k].copy() for k in ("y", "idx")})
                    losses.append(model.update(batch))
                    seen += len(batch["y"])
                model.finish()
            finally:
                reader.close()
            wall = time.perf_counter() - t0
            if not (np.isfinite(losses).all() and np.isfinite(model.weights()).all()):
                raise AssertionError(f"logreg file {name}: non-finite loss or weights")
            if parts and not all(np.array_equal(
                    np.concatenate([p[k] for p in parts]), ctr[k])
                    for k in ("y", "idx")):
                raise AssertionError("logreg file: the reader's batches differ "
                                     "from the data written")
            metrics[name] = {"examples": seen, "examples_per_s": seen / wall,
                             "first_loss": losses[0], "last_loss": losses[-1]}
        launches = {k.__name__: k.launches
                    for k in (rows.gather_rows, rows.scatter_add_rows)}
        snap = snapshot_tables([m.table for m in built.values()],
                               os.path.join(ckpt_dir, "logreg"))
    finally:
        mvt.shutdown()
    built = models()
    try:
        restore_s = restore_and_check([m.table for m in built.values()],
                                      os.path.join(ckpt_dir, "logreg"), snap,
                                      "logreg restore")
    finally:
        mvt.shutdown()
    del snap["before"]
    metrics.update(io_rates(snap, restore_s))
    print(f"logreg from config files on {card}: three PS models trained with "
          f"the reader in the loop, three tables restored bitwise", flush=True)
    return metrics, launches


# -- the device hash KV table --------------------------------------------------

def lda_keys(rng, adds: int, draws: int, vocab: int, topics: int) -> np.ndarray:
    """``(adds, draws)`` lightLDA word-topic keys ``word * topics + topic``:
    words from the bench's zipf counts, topics uniform."""
    words = zipf_tokens(rng, (adds, draws), vocab).astype(np.int64)
    return words * topics + rng.integers(0, topics, (adds, draws))


def count_ops(fn) -> int:
    """torch operators ``fn`` dispatches (each is a kernel launch on the
    card, bar the few that only touch metadata)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.ops


def cuda_kernels(fn):
    """CUDA kernels ``fn`` launches, from torch.profiler; "not measured"
    without a card or when the profiler sees no device activity."""
    if not torch.cuda.is_available():
        return "not measured"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.key.startswith("Memcpy"))
    return n if n > 0 else "not measured"


def kv_arrays(pairs: dict):
    """A whole-table Get's dict as (keys, values) arrays sorted by key."""
    k = np.fromiter(pairs.keys(), np.int64, len(pairs))
    v = np.fromiter(pairs.values(), np.float64, len(pairs))
    order = np.argsort(k)
    return k[order], v[order]


def device_kv_phase(mvt, device: str, card: str, adds: int = KV_ADDS,
                    draws: int = KV_DRAWS, vocab: int = 100_000,
                    topics: int = KV_TOPICS, point_gets: int = KV_POINT_GETS,
                    grown_capacity: int = 1 << 16):
    """The device hash KV table at the lightLDA shape of
    ``tests/test_kv_table.py``'s stress, at a user's size: ``adds`` Adds of
    ``draws`` word-topic keys (value 1.0) into a table sized for them
    (capacity twice the distinct keys) and into one that starts at
    ``grown_capacity`` and rebuilds as it fills. The whole-table Get, ``point_gets`` point
    Gets and a store/load round trip equal a numpy mirror exactly (the
    counts stay below 2^24, exact in float32)."""
    import io
    from multiverso_tpu_torch.ops import device_hash
    rng = np.random.default_rng(21)
    keys = lda_keys(rng, adds, draws, vocab, topics)
    uniq, inverse = np.unique(keys, return_inverse=True)
    mirror = np.bincount(inverse.ravel(), minlength=len(uniq)).astype(np.float64)
    if keys.max() >= 1 << 31 or mirror.max() >= 1 << 24:
        raise AssertionError("device KV phase: keys or counts out of range")
    probe = np.concatenate([rng.choice(uniq, point_gets // 2),
                            rng.integers(0, vocab * topics,
                                         point_gets - point_gets // 2)])
    at = np.minimum(np.searchsorted(uniq, probe), len(uniq) - 1)
    want_probe = np.where(uniq[at] == probe, mirror[at], 0.0)
    metrics = {"adds": adds, "draws_per_add": draws,
               "distinct_keys": int(len(uniq)), "max_count": int(mirror.max())}
    mvt.init(device=device)
    try:
        ones = np.ones(draws, np.float32)
        for label, capacity in (("sized", 2 * len(uniq)),
                                ("grown", grown_capacity)):
            table = mvt.create_table("kv", np.float32, capacity=capacity)
            server = table._server_table
            t0 = time.perf_counter()
            for i in range(adds):
                table.add(keys[i], ones)     # returns after its host read
            add_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pairs = table.get()
            whole_s = time.perf_counter() - t0
            gk, gv = kv_arrays(pairs)
            if not (np.array_equal(gk, uniq) and np.array_equal(gv, mirror)):
                raise AssertionError(f"device KV ({label}): the whole-table "
                                     f"Get differs from the mirror")
            del pairs
            t0 = time.perf_counter()
            got = np.asarray(table.get(probe), np.float64)
            get_s = time.perf_counter() - t0
            if not np.array_equal(got, want_probe):
                raise AssertionError(f"device KV ({label}): point Gets differ "
                                     f"from the mirror")
            if server._live != len(uniq):
                raise AssertionError(f"device KV ({label}): live count "
                                     f"{server._live} != {len(uniq)}")
            metrics[label] = {
                "initial_capacity": capacity, "add_keys_per_s": adds * draws / add_s,
                "add_ms_per_call": add_s / adds * 1e3,
                "point_get_keys_per_s": point_gets / get_s,
                "whole_get_s": whole_s, "whole_get_pairs_per_s": len(uniq) / whole_s,
                "rebuilds": server.rebuilds, "final_capacity": server.capacity,
                "device_bytes": server.device_bytes}
        if metrics["grown"]["rebuilds"] < 2:
            raise AssertionError("device KV: the growing table rebuilt "
                                 "fewer than twice")
        # store/load round trip of the grown table, on the dispatcher
        buf = io.BytesIO()
        t0 = time.perf_counter()
        mvt.Zoo.instance().server.run_serialized(lambda: server.store(buf))
        store_s = time.perf_counter() - t0
        fresh = mvt.create_table("kv", np.float32, capacity=grown_capacity)
        t0 = time.perf_counter()
        mvt.Zoo.instance().server.run_serialized(
            lambda: fresh._server_table.load(io.BytesIO(buf.getvalue())))
        load_s = time.perf_counter() - t0
        gk, gv = kv_arrays(fresh.get())
        if not (np.array_equal(gk, uniq) and np.array_equal(gv, mirror)):
            raise AssertionError("device KV: store/load changed the map")
        metrics["store_load"] = {"bytes": len(buf.getvalue()), "store_s": store_s,
                                 "load_s": load_s,
                                 "load_rebuilds": fresh._server_table.rebuilds}
        del buf, fresh
        # what one hash_add costs at the phase's batch: unique keys of one
        # Add into a table at load 0.25
        cap = 1 << 20
        hk = torch.full((cap + 1,), device_hash.EMPTY, dtype=torch.int32,
                        device=server.device)
        hv = torch.zeros(cap + 1, device=server.device)
        bk = torch.from_numpy(np.unique(keys[0]).astype(np.int32)).to(server.device)
        bv = torch.ones(len(bk), device=server.device)
        call = lambda: device_hash.hash_add(hk, hv, bk, bv, cap)  # noqa: E731
        metrics["hash_add"] = {"batch": int(len(bk)),
                               "torch_ops": count_ops(call),
                               "cuda_kernels": cuda_kernels(call)}
    finally:
        stop_runtime(mvt)
    print(f"device KV on {card}: {adds} Adds of {draws} word-topic keys, "
          f"{len(uniq)} distinct; maps, point Gets and store/load equal the "
          f"mirror exactly", flush=True)
    return metrics


# -- the top-k query plane -----------------------------------------------------

def topk_oracle(ids: np.ndarray, rows: np.ndarray, vecs: np.ndarray, k: int,
                metric: str):
    """numpy top-k under the ordering contract (score desc, id asc), one
    past k where the table has it: every row scoring at least the
    (k+1)-th score is a candidate, so ties at the boundary are all in."""
    rows = rows.astype(np.float32, copy=False)
    vecs = vecs.astype(np.float32)
    if metric == "cosine":
        eps = np.float32(1e-30)
        vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), eps)
        rows = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), eps)
    scores = vecs @ rows.T
    kk = min(k + 1, scores.shape[1])
    cut = -np.partition(-scores, kk - 1, axis=1)[:, kk - 1:kk]
    out_ids, out_scores = [], []
    for r in range(len(scores)):
        cand = np.nonzero(scores[r] >= cut[r])[0]
        order = np.lexsort((ids[cand], -scores[r, cand]))[:kk]
        out_ids.append(ids[cand][order])
        out_scores.append(scores[r, cand][order])
    return np.stack(out_ids), np.stack(out_scores).astype(np.float32)


def check_topk(got, want, k: int, exact: bool, what: str) -> None:
    """Hold a query's answer to the oracle's (one column past k): exact
    ids and scores where ``exact``; else scores within QUERY_RTOL /
    QUERY_ATOL and the ids exact except inside runs of oracle scores
    closer than that (such a run may swap members across the k
    boundary)."""
    ids, scores = got
    want_ids, want_scores = want
    kk = min(k, want_ids.shape[1])
    if ids.shape != (len(want_ids), kk):
        raise AssertionError(f"{what}: shape {ids.shape}, want {(len(want_ids), kk)}")
    if exact:
        if not (np.array_equal(ids, want_ids[:, :kk])
                and np.array_equal(scores, want_scores[:, :kk])):
            raise AssertionError(f"{what}: ids or scores differ from the oracle")
        return
    np.testing.assert_allclose(scores, want_scores[:, :kk], rtol=QUERY_RTOL,
                               atol=QUERY_ATOL, err_msg=what)
    for r in range(len(ids)):
        s = want_scores[r]
        close = np.abs(np.diff(s)) <= QUERY_ATOL + QUERY_RTOL * np.abs(s[1:])
        start = 0
        for j in range(kk):
            if j and not close[j - 1]:
                start = j
            end = j
            while end + 1 < len(s) and close[end]:
                end += 1
            ok = (ids[r, j] == want_ids[r, j] if start == end
                  else ids[r, j] in set(want_ids[r, start:end + 1].tolist()))
            if not ok:
                raise AssertionError(f"{what}: row {r} position {j} id "
                                     f"{ids[r, j]} is not the oracle's")
        if len(set(ids[r].tolist())) != kk:
            raise AssertionError(f"{what}: row {r} repeats an id")


def timed_queries(table, vecs_of, k: int, metric: str, calls: int):
    """``calls`` queries through ``table.query`` (the dispatcher), each
    with fresh vectors: (last answer, its vectors, call seconds)."""
    lat = []
    for i in range(calls):
        vecs = vecs_of(i)
        t0 = time.perf_counter()
        got = table.query(vecs, k, metric=metric)
        lat.append(time.perf_counter() - t0)
    return got, vecs, lat


def rate(lat, n_q: int) -> dict:
    return {"calls": len(lat), "queries_per_s": n_q * len(lat) / sum(lat),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def query_phase(mvt, rows, device: str, card: str, scratch: str,
                num_row: int = ROWS, num_col: int = COLS,
                w2v_rows: int = W2V["vocab_size"] + 1,
                grid_rows: int = 200_000, sparse_rows: int = 200_000,
                tiered_keys: int = 600_000, calls: int = 20):
    """``table.query`` / ``mvt.query`` through the dispatcher on (a) a
    1M x 50 matrix (16 query vectors, k = 16, bench.py:1466) under dot
    and cosine, after a burst of acknowledged row Adds it must see; (b) a
    word2vec ``w_in`` (100,001 x 128) for each probe word's 10 nearest by
    cosine; (c) an integer grid with exact ties across the k boundary;
    (d) a sparse table of 200,000 live rows of width 8; (e) one pass over
    a tiered sparse table of 600,000 keys x 8 at 10x its hot budget,
    8-bit cold segments, with no promotion. Each answer is held to the
    numpy oracle; TF32 is switched on around the queries to show the
    engine scores in full float32."""
    from multiverso_tpu_torch.dashboard import Dashboard
    rng = np.random.default_rng(31)
    n_q, k = 16, 16
    metrics = {}
    for kern in (rows.gather_rows, rows.scatter_add_rows):
        kern.launches = 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    mvt.init(device=device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        # (a) the PS shape, queried after 8 acknowledged 1024-row Adds (a
        # query drained with queued Adds is answered before them: lanes)
        table = mvt.create_table("matrix", num_row, num_col, np.float32,
                                 init_range=(-1.0, 1.0), seed=7)
        data = table.get()
        handles = []
        for _ in range(8):
            ids = rng.choice(num_row, BATCH, replace=False).astype(np.int32)
            vals = rng.standard_normal((BATCH, num_col), dtype=np.float32)
            data[ids] += vals
            handles.append(table.add_async(vals, row_ids=ids))
        for h in handles:
            table.wait(h)
        vecs = rng.standard_normal((n_q, num_col), dtype=np.float32)
        ids_all = np.arange(num_row)
        for metric in ("dot", "cosine"):
            got = mvt.query(table, vecs, k, metric)
            check_topk(got, topk_oracle(ids_all, data, vecs, k, metric), k,
                       False, f"matrix {metric}")
        for metric in ("dot", "cosine"):
            got, v, lat = timed_queries(
                table, lambda i: rng.standard_normal((n_q, num_col),
                                                     dtype=np.float32),
                k, metric, calls)
            check_topk(got, topk_oracle(ids_all, data, v, k, metric), k, False,
                       f"matrix {metric} (timed)")
            metrics[f"matrix_{metric}"] = rate(lat, n_q)
        del data

        # (b) nearest words in a w_in-shaped table (PSTrainer's init)
        dim = W2V["dim"]
        w_in = mvt.create_table("matrix", w2v_rows, dim, np.float32,
                                init_range=(-0.5 / dim, 0.5 / dim), seed=3)
        emb = w_in.get()
        ids_all = np.arange(w2v_rows)
        words = lambda i: rng.choice(w2v_rows, n_q, replace=False)  # noqa: E731
        probe = {}
        got, v, lat = timed_queries(
            w_in, lambda i: emb[probe.setdefault(i, words(i))], 10, "cosine",
            calls)
        check_topk(got, topk_oracle(ids_all, emb, v, 10, "cosine"), 10, False,
                   "w_in nearest words")
        if not np.array_equal(got[0][:, 0], probe[calls - 1]):
            raise AssertionError("w_in: a word is not its own nearest word")
        metrics["w_in_cosine_k10"] = rate(lat, n_q)
        del emb

        # (c) exact ties: 40 distinct integer rows, each repeated thousands
        # of times; every dot product is exact in float32
        base = rng.integers(-4, 5, (40, 16)).astype(np.float32)
        grid = base[rng.integers(0, 40, grid_rows)]
        gt = mvt.create_table("matrix", grid_rows, 16, np.float32,
                              init_value=grid)
        ids_all = np.arange(grid_rows)
        got, v, lat = timed_queries(
            gt, lambda i: rng.integers(-3, 4, (n_q, 16)).astype(np.float32),
            k, "dot", calls)
        check_topk(got, topk_oracle(ids_all, grid, v, k, "dot"), k, True,
                   "integer grid (ties)")
        metrics["grid_dot_ties"] = rate(lat, n_q)

        # (d) a sparse table, 200,000 live rows of width 8
        st = mvt.create_table("sparse", 1 << 30, width=8)
        skeys = np.sort(rng.choice(1 << 30, sparse_rows, replace=False))
        svals = rng.standard_normal((sparse_rows, 8), dtype=np.float32)
        for s in range(0, sparse_rows, 50_000):
            st.add(skeys[s:s + 50_000], svals[s:s + 50_000])
        for metric in ("dot", "cosine"):
            got, v, lat = timed_queries(
                st, lambda i: rng.standard_normal((n_q, 8), dtype=np.float32),
                k, metric, max(3, calls // 4))
            check_topk(got, topk_oracle(skeys, svals, v, k, metric), k, False,
                       f"sparse {metric}")
            metrics[f"sparse_{metric}"] = rate(lat, n_q)

        # (e) a tiered sparse table 10x over its hot budget, 8-bit cold
        width = 8
        tt = mvt.create_table("tiered_sparse", tiered_keys, width,
                              resident_bytes=tiered_keys * width * 4 // 10,
                              cold_bits=8, tier_dir=os.path.join(scratch, "tier"))
        t0 = time.perf_counter()
        for s in range(0, tiered_keys, 50_000):
            keys = np.arange(s, min(s + 50_000, tiered_keys), dtype=np.int64)
            tt.add(keys, rng.standard_normal((len(keys), width), dtype=np.float32))
        fill_s = time.perf_counter() - t0
        stats = tt._server_table.tier_stats()
        tkeys, trows = tt.get()          # decoded hot + cold rows, no churn
        counters = ("TIER_PROMOTIONS", "TIER_HOT_HITS", "TIER_COLD_HITS")
        before = [Dashboard.counter_value(c) for c in counters]
        seg0 = Dashboard.counter_value("QUERY_COMPRESSED_SEGMENTS")
        got, v, lat = timed_queries(
            tt, lambda i: rng.standard_normal((n_q, width), dtype=np.float32),
            k, "dot", 3)
        check_topk(got, topk_oracle(tkeys, trows, v, k, "dot"), k, False,
                   "tiered sparse (compressed domain)")
        after = [Dashboard.counter_value(c) for c in counters]
        if after != before or tt._server_table.tier_stats() != stats:
            raise AssertionError(f"tiered query moved the tier: {before} -> "
                                 f"{after}")
        metrics["tiered_dot"] = dict(
            rate(lat, n_q), fill_s=fill_s, **stats,
            compressed_segments=Dashboard.counter_value(
                "QUERY_COMPRESSED_SEGMENTS") - seg0)
        tt._server_table._tier.close()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        stop_runtime(mvt)
    launches = {k.__name__: k.launches for k in (rows.gather_rows,
                                                 rows.scatter_add_rows)}
    print(f"query plane on {card}: matrix, w_in, integer-grid ties, sparse "
          f"and tiered answers equal the oracle (ids exact, scores rtol "
          f"{QUERY_RTOL} atol {QUERY_ATOL}; the ties exact); the tiered scan "
          f"promoted nothing", flush=True)
    return metrics, launches


# ASGD: the reference's published ResNet-32 protocol
# (multiverso_tpu/models/resnet.py:1-30) on synthetic CIFAR-shaped data
ASGD_N, ASGD_EPOCHS, ASGD_BATCH = 10_240, 2, 128
ASGD_CHECK_DEPTH = 8           # the card-against-CPU and BSP checks
ASGD_BSP_ROUNDS = 8
ASGD_RTOL, ASGD_ATOL = 1e-4, 1e-5   # card against CPU, float32, TF32 off
# the table against init + the float64 sum of every delta the workers
# pushed: each float32 apply of a delta into weights of order 1 rounds by
# a few 1e-8. On an H100 rows 2-4 (161-644 pushes) read 6.0e-8 to
# 4.8e-7 and BSP (16 pushes) 1.2e-7; with the 10th push acknowledged but
# not applied (asgd_probe.py plants that in a copy of the port) rows 3
# and 4 read 0.051 and 0.108 after 2 epochs. The limit lies between, 21x
# over the largest sound reading
ASGD_CONSERVATION_ATOL = 1e-5
# one ResNet-32 step (rows 1-2's init, lr and first batch) on the card
# against the CPU's float32 step, relative L2 over the logits and over
# the update p1 - p0. On an H100 (asgd_probe.py): bf16 2.7e-3 and 1.8e-2
# (at depth 32 bf16 rounding noise is as large against a second bf16
# implementation, the CPU's: 2.7e-3 and 1.4e-2), float32 with TF32 off
# 2.9e-7 and 9.1e-5, a bf16 step on the next batch 0.26 on the update.
# The bf16 step must also read above 10x the float32 one (it ran in
# bf16), and the next batch's above the update limit (the limit tells
# gradients apart)
ASGD_BF16_LOGITS_REL, ASGD_BF16_UPDATE_REL = 1e-2, 0.06
ASGD_F32_LOGITS_REL, ASGD_F32_UPDATE_REL = 1e-5, 1e-3
# rows 1 and 2 (one worker, without and with the PS) at lr 0.01 and
# momentum 0.9: at the reference's lr 0.1 without a warm-up ResNet-32 does
# not learn this data in 2 epochs (on an H100, asgd_probe.py: 0.205 in
# bf16, 0.178 in float32, 0.109 through the PS); at lr 0.01 the two rows
# read 0.972 and 0.976. Each must reach ASGD_ROW12_BAR, and row 2 (the PS
# path) must stay within ASGD_ROW12_GAP of row 1 (0.002-0.010 apart at
# lr 0.01-0.02)
ASGD_ROW12 = dict(lr=0.01, momentum=0.9)
ASGD_ROW12_BAR, ASGD_ROW12_GAP = 0.8, 0.05
# row 3: 4 workers at lr 0.02, momentum 0.5, for 8 epochs where the other
# rows take 2. Each worker steps on parameters it pulled before its 3
# peers pushed (the JAX trainer's cadence: step, then sync), so the
# merged model moves about a round of 4 batches at a time: on an H100 it
# read 0.101-0.151 after 2 epochs (chance is 0.1, the largest class
# 0.104; asgd_probe.py: the same cadence run by one thread in turns
# 0.104-0.179, against 0.36-0.69 with a pull right before each step),
# 0.348 after 4 and 0.694-0.912 after 8. The merged model must reach 0.3
ASGD_ROW3_EPOCHS = 8
ASGD_LEARN_BAR = 0.3


class DeltaLedger:
    """Wraps a table proxy's pair pushes (``sync_leaves_async`` with a
    baseline, ``push_leaves_async``): on the calling worker's side, before
    the push goes out, it adds ``new - last`` into a float64 sum. At the end
    the table must equal ``init + sum``: no push lost, none read after the
    worker stepped its parameters in place."""

    def __init__(self, table) -> None:
        self.table, self.total, self.pushes = table, None, 0
        self._lock = threading.Lock()
        sync, push = table.sync_leaves_async, table.push_leaves_async

        def flat(leaves):
            return torch.cat([x.detach().reshape(-1).double() for x in leaves])

        def record(new, last):
            d = flat(new) - flat(last)
            with self._lock:
                self.total = d if self.total is None else self.total + d
                self.pushes += 1

        def sync_leaves_async(delta_leaves, option=None, last_leaves=None):
            if last_leaves is not None:
                record(delta_leaves, last_leaves)
            return sync(delta_leaves, option, last_leaves)

        def push_leaves_async(new_leaves, last_leaves, option=None):
            record(new_leaves, last_leaves)
            return push(new_leaves, last_leaves, option)

        table.sync_leaves_async = sync_leaves_async
        table.push_leaves_async = push_leaves_async

    def check(self, mvt, init: np.ndarray, what: str) -> float:
        with mvt.Zoo.instance().admin():
            final = self.table.get()
        want = init.astype(np.float64) + self.total.cpu().numpy()
        err = float(np.abs(final - want).max())
        if not err <= ASGD_CONSERVATION_ATOL:
            raise AssertionError(f"{what}: table - (init + sum of {self.pushes} "
                                 f"pushed deltas) max |diff| {err}")
        return err


def sync_device(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def asgd_row(mvt, resnet, device: str, cfg, X, y, workers: int,
             pipeline: bool = False, epochs: int = ASGD_EPOCHS,
             batch: int = ASGD_BATCH, hold=None):
    """One ``ASGDTrainer`` row in a fresh runtime: images/s, s/epoch, the
    worker-side sync p50/p99, training-set accuracy, the conservation
    error. ``hold(trainer, state)`` runs before the runtime stops."""
    mvt.init(local_workers=workers, device=device)
    try:
        trainer = resnet.ASGDTrainer(cfg, workers=workers, sync_freq=1,
                                     input_shape=X.shape[1:], pipeline=pipeline)
        book = DeltaLedger(trainer.manager.table)
        with mvt.Zoo.instance().admin():
            init = trainer.manager.table.get()
        sync_device(device)
        t0 = time.perf_counter()
        state = trainer.train(X, y, epochs=epochs, batch=batch, timeout=JOIN_S)
        sync_device(device)
        seconds = time.perf_counter() - t0
        steps = workers * epochs * ((len(X) // workers) // batch)
        sync_ms = np.array(trainer.sync_seconds) * 1e3
        out = {"workers": workers, "pipeline": pipeline,
               "images_per_s": steps * batch / seconds,
               "s_per_epoch": seconds / epochs, "steps": steps,
               "sync_p50_ms": float(np.percentile(sync_ms, 50)),
               "sync_p99_ms": float(np.percentile(sync_ms, 99)),
               "accuracy": resnet.evaluate(trainer.model, cfg, state, X, y)}
        out["conservation_max_abs"] = book.check(
            mvt, init, f"ASGD {workers} workers pipeline={pipeline}")
        out["pushes"] = book.pushes
        if hold is not None:
            out.update(hold(trainer, state))
        return out
    finally:
        stop_runtime(mvt)


def asgd_plain_row(resnet, device: str, cfg, X, y, epochs: int = ASGD_EPOCHS,
                   batch: int = ASGD_BATCH) -> dict:
    """Row 1: one worker, no PS: the train step over the same device-side
    batches the trainer draws (the data uploaded once, a shuffled order)."""
    dev = torch.device(device)
    model, variables = resnet.init_resnet(cfg, 0, (1,) + X.shape[1:], device=dev)
    step = resnet.make_train_step(model, cfg)
    state = resnet.train_state(model, cfg, variables)
    xs = torch.from_numpy(X).to(dev)
    ys = torch.from_numpy(y.astype(np.int64)).to(dev)
    order, rng = np.arange(len(X)), np.random.default_rng(0)
    steps = 0
    sync_device(device)
    t0 = time.perf_counter()
    for _ in range(epochs):
        rng.shuffle(order)
        for i in range(0, len(X) - batch + 1, batch):
            idx = torch.from_numpy(order[i:i + batch]).to(dev)
            state, _ = step(state, xs[idx], ys[idx], cfg.lr)
            steps += 1
    sync_device(device)
    seconds = time.perf_counter() - t0
    return {"workers": 1, "ps": False, "images_per_s": steps * batch / seconds,
            "s_per_epoch": seconds / epochs, "steps": steps,
            "accuracy": resnet.evaluate(model, cfg, state, X, y)}


def asgd_card_vs_cpu(mvt, resnet, device: str, X, y, depth: int, width: int,
                     batch: int) -> dict:
    """The port in float32 with TF32 off: logits of one batch from the same
    seeded init on ``device`` and on the CPU; then a 1-worker trainer's
    parameters after 3 steps and its one (final) sync, on both."""
    cfg = resnet.ResNetConfig(depth=depth, width=width,
                              compute_dtype=torch.float32)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lg, params = {}, {}
        for dev in (device, "cpu"):
            model, v = resnet.init_resnet(cfg, 0, (1,) + X.shape[1:], device=dev)
            lg[dev] = resnet.logits(model, v, X[:batch]).cpu().numpy()
            mvt.init(local_workers=1, device=dev)
            try:
                trainer = resnet.ASGDTrainer(cfg, workers=1, sync_freq=4,
                                             input_shape=X.shape[1:])
                state = trainer.train(X[:3 * batch], y[:3 * batch], epochs=1,
                                      batch=batch, timeout=JOIN_S)
                params[dev] = torch.cat([state["params"][k].reshape(-1).cpu()
                                         for k in sorted(state["params"])]).numpy()
            finally:
                stop_runtime(mvt)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    out = {}
    for what, got, want in (("logits", lg[device], lg["cpu"]),
                            ("params after 3 steps and a sync",
                             params[device], params["cpu"])):
        np.testing.assert_allclose(got, want, rtol=ASGD_RTOL, atol=ASGD_ATOL,
                                   err_msg=f"ASGD card against CPU: {what}")
        out[what.split()[0] + "_max_abs_diff"] = float(np.abs(got - want).max())
    return out


def asgd_bf16_step(resnet, device: str, X, y, depth: int, width: int,
                   batch: int, ref_dtype=torch.float32) -> dict:
    """One ResNet-``depth`` train step at rows 1-2's settings from the same
    seeded init and batch: the CPU's step in ``ref_dtype`` is the
    reference, and each card step reads relative L2 errors of the logits
    before the step and of the update ``p1 - p0``, and the loss's relative
    error. The card steps: bf16 autocast (the rows' step), float32 with
    TF32 off, and bf16 on the next batch (a gradient that is not this
    batch's)."""
    def flat(params):
        return torch.cat([params[k].detach().reshape(-1).double().cpu()
                          for k in sorted(params)])

    def run(dev, dtype, lo=0):
        cfg = resnet.ResNetConfig(depth=depth, width=width,
                                  compute_dtype=dtype, **ASGD_ROW12)
        model, v = resnet.init_resnet(cfg, 0, (1,) + X.shape[1:], device=dev)
        p0 = flat(v["params"])
        lg = resnet.logits(model, v, X[:batch]).double().cpu()
        state, loss = resnet.make_train_step(model, cfg)(
            resnet.train_state(model, cfg, v), X[lo:lo + batch],
            y[lo:lo + batch], cfg.lr)
        return lg, float(loss), flat(state["params"]) - p0

    ref = run("cpu", ref_dtype)

    def errors(got):
        return {"logits": float((got[0] - ref[0]).norm() / ref[0].norm()),
                "loss": abs(got[1] - ref[1]) / abs(ref[1]),
                "update": float((got[2] - ref[2]).norm() / ref[2].norm())}

    out = {"bf16": errors(run(device, torch.bfloat16)),
           "other_batch": errors(run(device, torch.bfloat16, batch))}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["float32"] = errors(run(device, torch.float32))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    out["loss"] = ref[1]
    return out


def asgd_bsp(mvt, resnet, device: str, X, y, depth: int, width: int,
             batch: int, rounds: int = ASGD_BSP_ROUNDS) -> dict:
    """Two workers under BSP (``-sync``), ``rounds`` rounds of one step and
    one view sync each: every round both workers pull equal parameters,
    and the final table equals init + the sum of the pushed deltas."""
    import copy

    from multiverso_tpu_torch.ext import PytreeParamManager
    mvt.init(sync=True, local_workers=2, device=device)
    try:
        cfg = resnet.ResNetConfig(depth=depth, width=width, lr=0.02,
                                  momentum=0.5)
        model, v = resnet.init_resnet(cfg, 0, (1,) + X.shape[1:], device=device)
        pm = PytreeParamManager(v["params"])
        book = DeltaLedger(pm.table)
        with mvt.Zoo.instance().admin():
            init = pm.table.get()
        views = [pm.worker_view(device=True) for _ in range(2)]
        pulled = [[None] * rounds for _ in range(2)]
        xs = torch.from_numpy(X[:2 * rounds * batch]).to(device)
        ys = torch.from_numpy(y[:2 * rounds * batch].astype(np.int64)).to(device)

        def work(slot):
            with mvt.worker(slot):
                step = resnet.make_train_step(copy.deepcopy(model), cfg)
                state = resnet.train_state(model, cfg,
                                           {"params": views[slot].params})
                for r in range(rounds):
                    lo = (slot * rounds + r) * batch
                    state, _ = step(state, xs[lo:lo + batch], ys[lo:lo + batch],
                                    cfg.lr)
                    state["params"] = views[slot].sync(state["params"])
                    pulled[slot][r] = torch.cat(
                        [state["params"][k].reshape(-1)
                         for k in sorted(state["params"])])

        join_workers(2, work, JOIN_S)
        for r in range(rounds):
            if not torch.equal(pulled[0][r], pulled[1][r]):
                raise AssertionError(f"BSP ASGD: round {r}: the two workers "
                                     f"pulled different parameters")
        err = book.check(mvt, init, "BSP ASGD")
        return {"rounds": rounds, "pushes": book.pushes,
                "conservation_max_abs": err}
    finally:
        stop_runtime(mvt)


def asgd_aggregate(mvt, device: str, shapes, calls: int = 20) -> dict:
    """``mvt.aggregate`` across 4 workers of host arrays, host leaf lists and
    device tensor lists in ResNet-32's leaf shapes, integer-valued floats:
    each sum equal to numpy's exactly, each worker's device result its own
    buffers; ms a call (host clock, device synchronised)."""
    workers = WORKERS
    mvt.init(ma=True, local_workers=workers, device=device)
    try:
        host = {s: [np.random.default_rng(s).integers(-8, 9, size=sh)
                    .astype(np.float32) for sh in shapes] for s in range(workers)}
        dev = {s: [torch.from_numpy(x).to(device) for x in host[s]]
               for s in range(workers)}
        flat = {s: np.concatenate([x.reshape(-1) for x in host[s]])
                for s in range(workers)}
        want = [sum(host[s][i] for s in range(workers)) for i in range(len(shapes))]
        kinds = {"host_array": flat, "host_leaves": host, "device_leaves": dev}
        results, ms = {}, {}
        for kind, values in kinds.items():
            got = {}

            def work(slot):
                with mvt.worker(slot):
                    got[slot] = mvt.aggregate(values[slot])
                    for _ in range(calls - 1):
                        mvt.aggregate(values[slot])

            sync_device(device)
            t0 = time.perf_counter()
            join_workers(workers, work, JOIN_S)
            sync_device(device)
            ms[kind] = (time.perf_counter() - t0) * 1e3 / calls
            results[kind] = got
        for s in range(workers):
            np.testing.assert_array_equal(
                results["host_array"][s],
                np.concatenate([w.reshape(-1) for w in want]))
            for kind in ("host_leaves", "device_leaves"):
                for g, w in zip(results[kind][s], want, strict=True):
                    g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
                    np.testing.assert_array_equal(g, w, err_msg=kind)
        ptrs = [x.data_ptr() for s in range(workers)
                for x in results["device_leaves"][s]]
        if len(set(ptrs)) != len(ptrs):
            raise AssertionError("aggregate: workers share device buffers")
        for x in results["device_leaves"][0]:
            x.add_(1.0)
        for s in range(1, workers):
            for g, w in zip(results["device_leaves"][s], want):
                np.testing.assert_array_equal(g.cpu().numpy(), w)
        return {f"{k}_ms_per_call": v for k, v in ms.items()}
    finally:
        stop_runtime(mvt)


def asgd_phase(mvt, device: str, scratch: str, depth: int = 32,
               width: int = 16, n: int = ASGD_N, batch: int = ASGD_BATCH,
               check_depth: int = ASGD_CHECK_DEPTH, learn_bar=ASGD_LEARN_BAR,
               row12_bar=ASGD_ROW12_BAR,
               profiled: bool = True) -> dict:
    """ResNet-``depth`` ASGD on ``device``: rows 1-4, the checks, the
    checkpoint, ``mvt.aggregate``, the idle share of row 3."""
    from multiverso_tpu_torch.checkpoint import CheckpointDriver
    from multiverso_tpu_torch.ext import PytreeParamManager
    from multiverso_tpu_torch.models import resnet

    t_phase = time.perf_counter()
    X, y = resnet.synthetic_cifar(n, 10, seed=0, shape=(32, 32, 3))
    metrics = {"card_vs_cpu": asgd_card_vs_cpu(mvt, resnet, device, X, y,
                                               check_depth, width, batch)}
    step = metrics["bf16_step"] = asgd_bf16_step(resnet, device, X, y, depth,
                                                 width, batch)
    for what, err, lg_lim, up_lim in (
            ("bf16", step["bf16"], ASGD_BF16_LOGITS_REL, ASGD_BF16_UPDATE_REL),
            ("float32", step["float32"], ASGD_F32_LOGITS_REL,
             ASGD_F32_UPDATE_REL)):
        if not (err["logits"] <= lg_lim and err["update"] <= up_lim):
            raise AssertionError(f"ASGD {what} step against the CPU's float32 "
                                 f"step: {err} (limits {lg_lim}, {up_lim})")
    if not step["bf16"]["logits"] > 10 * step["float32"]["logits"]:
        raise AssertionError(f"ASGD: the bf16 step reads like a float32 one: "
                             f"{step}")
    if not step["other_batch"]["update"] > ASGD_BF16_UPDATE_REL:
        raise AssertionError(f"ASGD: the update limit passes another batch's "
                             f"step: {step['other_batch']}")
    base = resnet.ResNetConfig(depth=depth, width=width, **ASGD_ROW12)
    n_params = sum(p.numel() for p in resnet.init_resnet(
        base, 0, device="cpu")[1]["params"].values())
    metrics["params"] = n_params
    metrics["table_bytes"] = 4 * n_params
    # warm-up: the convolutions' first calls at this shape and dtype
    warm = asgd_plain_row(resnet, device, base, X[:4 * batch], y[:4 * batch],
                          epochs=1, batch=batch)
    metrics["warmup_s"] = warm["s_per_epoch"]
    rows = {"1_no_ps": asgd_plain_row(resnet, device, base, X, y, batch=batch),
            "2_ps_1_worker": asgd_row(mvt, resnet, device, base, X, y, 1,
                                      batch=batch)}
    asgd = resnet.ResNetConfig(depth=depth, width=width, lr=0.02, momentum=0.5)
    ckpt = os.path.join(scratch, "asgd")

    def snapshot(trainer, state):
        CheckpointDriver([trainer.manager.table], ckpt).snapshot()
        return {"_trained": {k: v.clone() for k, v in state["params"].items()}}

    rows["3_asgd_4_workers"] = asgd_row(mvt, resnet, device, asgd, X, y,
                                        WORKERS, epochs=ASGD_ROW3_EPOCHS,
                                        batch=batch, hold=snapshot)
    rows["4_asgd_4_workers_pipelined"] = asgd_row(
        mvt, resnet, device, asgd, X, y, WORKERS, pipeline=True,
        batch=batch)
    r1, r2, r3 = rows["1_no_ps"], rows["2_ps_1_worker"], rows["3_asgd_4_workers"]
    metrics["ps_overhead_pct"] = 100.0 * (r2["s_per_epoch"] - r1["s_per_epoch"]) \
        / r1["s_per_epoch"]
    for name, r in (("1", r1), ("2", r2)):
        if not r["accuracy"] >= row12_bar:
            raise AssertionError(f"ASGD row {name}: accuracy {r['accuracy']} "
                                 f"under the bar {row12_bar}")
    if not abs(r2["accuracy"] - r1["accuracy"]) <= ASGD_ROW12_GAP:
        raise AssertionError(f"ASGD: row 2 (the PS path) {r2['accuracy']} "
                             f"against row 1 {r1['accuracy']}")
    if not r3["accuracy"] >= learn_bar:
        raise AssertionError(f"ASGD row 3: accuracy {r3['accuracy']} under "
                             f"the bar {learn_bar}")
    # the checkpoint of row 3's table, restored into a fresh world
    trained = r3.pop("_trained")
    mvt.init(local_workers=1, device=device)
    try:
        pm = PytreeParamManager({k: torch.zeros_like(v) for k, v in trained.items()})
        if not CheckpointDriver([pm.table], ckpt).restore():
            raise AssertionError("ASGD checkpoint: nothing restored")
        restored = pm.worker_view(device=True).params
        for k, v in trained.items():
            if not torch.equal(restored[k], v):
                raise AssertionError(f"ASGD checkpoint: {k} differs")
    finally:
        stop_runtime(mvt)
    metrics["checkpoint"] = "restored bitwise"
    metrics["bsp"] = asgd_bsp(mvt, resnet, device, X, y, check_depth, width,
                              batch)
    shapes = [tuple(p.shape) for _, p in sorted(resnet.init_resnet(
        base, 0, device="cpu")[1]["params"].items())]
    metrics["aggregate"] = asgd_aggregate(mvt, device, shapes)
    if profiled:
        # the card's idle share while 4 workers train (one epoch of row
        # 3's configuration, traced)
        mvt.init(local_workers=WORKERS, device=device)
        try:
            trainer = resnet.ASGDTrainer(asgd, workers=WORKERS,
                                         sync_freq=1, input_shape=X.shape[1:])
            prof = profile(lambda: (trainer.train(X, y, epochs=1, batch=batch,
                                                  timeout=JOIN_S),
                                    sync_device(device)))
        finally:
            stop_runtime(mvt)
        busy = prof["device_busy_ms"]
        prof["idle_share"] = (1.0 - busy / prof["wall_ms"]
                              if isinstance(busy, float) else "not measured")
        metrics["row3_profile"] = prof
    metrics["rows"] = rows
    metrics["phase_s"] = time.perf_counter() - t_phase
    return metrics


# -- 14. serving over the wire -------------------------------------------------
# The tables stay in this process, on the card; each client is a fresh
# interpreter running this script with --client (bench.py's _apply_child
# pattern turned around: the server is ours, the clients are children).

SERVE_CLIENTS = 4                 # client processes of the PS and overload legs
SERVE_ROUNDS = 128                # 1024-row rounds per PS client
# bench.py bench_apply_path: 65,536 x 128 fp32, 1024-row Adds, 400 Adds
# from 4 producer threads with a window of 32 async Adds each
APPLY_ROWS, APPLY_COLS = 65_536, 128
APPLY_ADDS, APPLY_PRODUCERS, APPLY_WINDOW = 400, 4, 32
APPLY_SETS = 8                    # unique-id batches in rotation
BSP_WIRE_ROUNDS = 8
BSP_VICTIM_ADDS = 5               # the killed client's Adds: 4 rounds + 1
LEASE_S = 2.0
ONCE_ADDS, ONCE_WINDOW = 64, 32   # per client in the exactly-once legs
# leg 4's overload cases: a backlog limit of a quarter of the 128 Adds in
# flight, and a deadline of about ten served Adds, so that a share of the
# Adds is acknowledged and a share refused
ONCE_QUEUE_LIMIT, ONCE_DEADLINE_S = 32, 0.02
W2V_WIRE_BLOCKS = 16              # timed 8192-token blocks over the wire
CLIENT_S = 300                    # a client process's limit


class Client:
    """One client process (``chip_smoke.py --client``): it runs the jobs it
    is sent, one JSON line each, until ``EXIT``. Its stdout lines queue up
    for :meth:`expect`; its stderr goes to a file whose tail a failure
    quotes. ``args`` starts another role of this script instead (phase
    15's ``--durable-primary``), named ``name``."""

    def __init__(self, scratch: str, n: int, args=("--client",),
                 name: str = "") -> None:
        self.name = name or f"client{n}"
        self.killed = False
        self.err_path = os.path.join(scratch, f"{self.name}.err")
        self._err = open(self.err_path, "w")
        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._err,
            text=True, cwd=here)
        self._lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line.rstrip("\n"))
        self._lines.put(None)

    def _tail(self) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return "".join(f.readlines()[-15:])

    def expect(self, prefix: str, timeout: float = CLIENT_S) -> str:
        """The rest of the first line starting with ``prefix``; other lines
        pass through to this script's output."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"{self.name}: no {prefix!r} line in "
                                   f"{timeout} s\n{self._tail()}") from None
            if line is None:
                raise AssertionError(
                    f"{self.name} ended (code {self.proc.wait()}) before "
                    f"{prefix!r}\n{self._tail()}")
            if line.startswith(prefix):
                return line[len(prefix):].strip()
            print(f"  {self.name}: {line}", flush=True)

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def job(self, spec: dict) -> None:
        self.send(json.dumps(spec))

    def result(self, timeout: float = CLIENT_S) -> dict:
        return json.loads(self.expect("RESULT", timeout))

    def kill(self) -> None:
        """SIGKILL, as a crash."""
        self.killed = True
        self.proc.kill()
        self.proc.wait(timeout=30)

    def close(self) -> None:
        """EXIT and a zero exit code, or the tail of stderr."""
        try:
            if self.proc.poll() is None and not self.killed:
                self.send("EXIT")
                code = self.proc.wait(timeout=60)
                if code != 0:
                    raise AssertionError(f"{self.name} exited {code}\n"
                                         f"{self._tail()}")
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)
            self._err.close()


class ClientPool:
    """The phase's client processes, started together once (each takes a
    few seconds to import torch); every one is stopped on the way out."""

    def __init__(self, n: int, scratch: str) -> None:
        self.procs = [Client(scratch, i) for i in range(n)]

    def __enter__(self) -> "ClientPool":
        return self

    def take(self, n: int) -> list:
        if n > len(self.procs):
            raise AssertionError(f"{n} clients asked for, {len(self.procs)} "
                                 "alive")
        return self.procs[:n]

    def drop(self, proc: Client) -> None:
        proc.kill()
        self.procs.remove(proc)

    def __exit__(self, *exc) -> None:
        errors = []
        for p in self.procs:
            try:
                p.close()
            except BaseException as err:  # stop them all, then report
                errors.append(err)
        if errors and exc[0] is None:
            raise errors[0]


def run_jobs(procs, specs, reset=None) -> list:
    """Send each client its job; when every one has connected (READY),
    ``reset()`` (zero this process's counters) and GO to all; their
    results."""
    for p, spec in zip(procs, specs):
        p.job(spec)
    for p in procs:
        p.expect("READY")
    if reset is not None:
        reset()
    for p in procs:
        p.send("GO")
    return [p.result() for p in procs]


def wait_go() -> None:
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        raise SystemExit("client: no GO from the server")


def int_rows(rng, shape) -> np.ndarray:
    """Integer-valued float32 deltas in [-3, 3]: every float32 sum of a
    run's Adds is exact, in any order."""
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def ps_round(seed: int, idx: int, k: int, num_row: int, num_col: int,
             batch: int):
    """PS client ``idx``'s round ``k``: Add ids (duplicates included), Add
    values, Get ids."""
    rng = np.random.default_rng([seed, idx, k])
    return (rng.integers(0, num_row, batch).astype(np.int32),
            rng.standard_normal((batch, num_col), dtype=np.float32),
            rng.integers(0, num_row, batch).astype(np.int32))


def bsp_round(seed: int, idx: int, k: int, num_row: int, num_col: int,
              batch: int):
    rng = np.random.default_rng([seed, idx, k, 1])
    return (rng.integers(0, num_row, batch).astype(np.int32),
            int_rows(rng, (batch, num_col)),
            rng.integers(0, num_row, batch).astype(np.int32))


def once_add(seed: int, idx: int, i: int, num_row: int, num_col: int,
             batch: int):
    rng = np.random.default_rng([seed, idx, i, 2])
    return (rng.integers(0, num_row, batch).astype(np.int32),
            int_rows(rng, (batch, num_col)))


def apply_sets(num_row: int, num_col: int, batch: int):
    rng = np.random.default_rng(11)
    return [(rng.choice(num_row, batch, replace=False).astype(np.int32),
             int_rows(rng, (batch, num_col))) for _ in range(APPLY_SETS)]


# -- the client roles (run in the child processes) ---------------------------

def client_ps(mvt, s: dict) -> dict:
    """Leg 1: ``rounds`` timed rounds of a 1024-row Add and Get on the
    default matrix, then ``rounds // 4`` Adds to the AdaGrad matrix and the
    array table, as the in-process PS phase does; client-side latencies
    and this client's wire monitors."""
    from multiverso_tpu_torch.dashboard import Dashboard
    client = mvt.remote_connect(s["endpoint"])
    mat, ada, arr = client.table(0), client.table(1), client.table(2)
    opt = mvt.AddOption(worker_id=client.worker_id, learning_rate=0.1, rho=0.1)
    wait_go()
    add_us, get_us = [], []
    start = time.time()
    for k in range(s["rounds"]):
        ids, vals, gids = ps_round(s["seed"], s["idx"], k, s["num_row"],
                                   s["num_col"], s["batch"])
        t0 = time.perf_counter()
        mat.add(vals, row_ids=ids)
        t1 = time.perf_counter()
        got = mat.get(gids)
        t2 = time.perf_counter()
        add_us.append((t1 - t0) * 1e6)
        get_us.append((t2 - t1) * 1e6)
        if got.shape != (s["batch"], s["num_col"]) or not np.isfinite(got).all():
            raise AssertionError(f"bad Get reply {got.shape}")
    end = time.time()
    wire_ms = {name: Dashboard.get(name).average_ms
               for name in ("WIRE_ENCODE", "WIRE_DECODE")}
    for k in range(s["rounds"] // 4):
        ids, vals, _ = ps_round(s["seed"], s["idx"], k, s["num_row"],
                                s["num_col"], s["batch"])
        ada.add(vals, row_ids=ids, option=opt)
        arr.add(np.full(s["num_row"], s["idx"] + k, np.float32))
    client.close()
    return {"worker_id": client.worker_id, "start": start, "end": end,
            "add_us": add_us, "get_us": get_us, "client_wire_ms": wire_ms,
            "adds": s["rounds"] + 2 * (s["rounds"] // 4)}


def client_apply(mvt, s: dict) -> dict:
    """Leg 2: bench_apply_path's producers, integer-valued deltas."""
    client = mvt.remote_connect(s["endpoint"])
    table = client.table(0)
    sets = apply_sets(s["num_row"], s["num_col"], s["batch"])
    per = s["adds"] // s["producers"]
    wait_go()

    def push(_slot):
        handles = []
        for i in range(per):
            ids, vals = sets[i % APPLY_SETS]
            handles.append(table.add_async(vals, row_ids=ids))
            if len(handles) >= s["window"]:
                table.wait(handles.pop(0))
        for h in handles:
            table.wait(h)

    t0 = time.perf_counter()
    join_workers(s["producers"], push, timeout=CLIENT_S)
    dt = time.perf_counter() - t0
    client.close()
    n = per * s["producers"]
    return {"adds": n, "per_producer": per, "seconds": dt,
            "adds_per_s": n / dt,
            "gbps": n * s["batch"] * s["num_col"] * 4 / dt / 1e9}


def client_bsp(mvt, s: dict) -> dict:
    """Leg 3: BSP rounds; every Get is held against the mirror after
    exactly that many rounds of every client (bitwise: integer deltas).
    The victim stops after its ``adds``-th Add and waits to be killed."""
    client = mvt.remote_connect(s["endpoint"])
    table = client.table(0)
    R, C, B = s["num_row"], s["num_col"], s["batch"]
    adds = s["adds"]                  # Adds of each client, by idx
    mirror = np.zeros((R, C), np.float32)
    wait_go()
    me = s["idx"]
    for k in range(adds[me]):
        ids, vals, gids = bsp_round(s["seed"], me, k, R, C, B)
        table.add(vals, row_ids=ids)
        if s.get("victim") and k == adds[me] - 1:
            print(f"MIDROUND {client.worker_id}", flush=True)
            time.sleep(CLIENT_S)      # killed here, mid-round
        got = table.get(gids)
        for w, n in enumerate(adds):
            if k < n:
                w_ids, w_vals, _ = bsp_round(s["seed"], w, k, R, C, B)
                np.add.at(mirror, w_ids, w_vals)
        if not np.array_equal(got, mirror[gids]):
            raise AssertionError(
                f"BSP round {k + 1}: Get differs from the mirror by "
                f"{float(np.abs(got - mirror[gids]).max())}")
    table.finish_train()
    client.close()
    return {"worker_id": client.worker_id, "rounds": adds[me]}


def client_once(mvt, s: dict) -> dict:
    """Leg 4: ``adds`` integer-valued Adds with ``window`` in flight. Each
    is acknowledged, shed (a ``shed: ...`` reply, seen on the wire here) or
    expired (a ``deadline_exceeded`` failure)."""
    from multiverso_tpu_torch.runtime import net as net_mod
    from multiverso_tpu_torch.runtime import wire
    from multiverso_tpu_torch.runtime.message import MsgType
    shed_msgs = set()
    recv = net_mod.TcpNet.recv

    def observed_recv(net):
        msg = recv(net)
        if msg is not None and msg.type == MsgType.Reply_Error:
            text = wire.decode(msg.data)
            if isinstance(text, str) and text.startswith("shed:"):
                shed_msgs.add(msg.msg_id)
        return msg

    net_mod.TcpNet.recv = observed_recv   # every reply frame, from the first
    try:
        return _once_adds(mvt, s, shed_msgs)
    finally:
        net_mod.TcpNet.recv = recv


def _once_adds(mvt, s: dict, shed_msgs: set) -> dict:
    client = mvt.remote_connect(s["endpoint"])
    table = client.table(0)
    wait_go()
    handles, acked, shed, expired = [], [], [], []

    def settle(i, h):
        try:
            table.wait(h)
        except RuntimeError as exc:
            if "deadline_exceeded" not in str(exc):
                raise
            expired.append(i)
            return
        (shed if h in shed_msgs else acked).append(i)

    for i in range(s["adds"]):
        ids, vals = once_add(s["seed"], s["idx"], i, s["num_row"],
                             s["num_col"], s["batch"])
        handles.append((i, table.add_async(vals, row_ids=ids)))
        if len(handles) >= s["window"]:
            settle(*handles.pop(0))
    for i, h in handles:
        settle(i, h)
    client.close()
    return {"acked": acked, "shed": shed, "expired": expired}


def w2v_setup(w2v=None):
    from multiverso_tpu_torch.models.vocab import Dictionary
    from multiverso_tpu_torch.models.word2vec import Word2VecConfig
    config = Word2VecConfig(**dict(W2V, **(w2v or {})))
    d = Dictionary()
    d.words = [f"w{i}" for i in range(config.vocab_size)]
    d.counts = w2v_counts(config.vocab_size)
    return config, d


def client_w2v(mvt, s: dict) -> dict:
    """Leg 5: ``PSTrainer`` on remote proxies of the server's w_in, w_out
    and count tables; the step runs on ``device`` in this process. One
    block, then (after GO) ``timed`` blocks through the pipelined loop."""
    from multiverso_tpu_torch.models.word2vec import PSTrainer
    from multiverso_tpu_torch.ops import sgns
    config, d = w2v_setup(s.get("w2v"))
    rng = np.random.default_rng(0)
    blocks = [zipf_tokens(rng, config.block_tokens, config.vocab_size)
              for _ in range(1 + s["timed"])]
    sgns.sgns_chunk.launches = 0
    mvt.init(device=s["device"])
    try:
        tr = PSTrainer(config, d)
        client = mvt.remote_connect(s["endpoint"])
        tr.input_table, tr.output_table, tr.count_table = (
            client.table(0), client.table(1), client.table(2))
        if tr.input_table.supports_device_io:
            raise AssertionError("a remote proxy claims device IO")
        loss = tr.train_block(blocks[0])
        print(f"BLOCK1 {loss}", flush=True)
        out = {"loss": loss, "stats": tr.last_block_stats}
        if s["timed"]:
            wait_go()
            t0 = time.perf_counter()
            tr.train(blocks[1:], group=1, log_every_s=1e9)
            wall = time.perf_counter() - t0  # train() ends on a stats read
            out.update(words_per_s=(tr.words_trained - len(blocks[0])) / wall,
                       blocks=s["timed"], seconds=wall)
        out["sgns_launches"] = sgns.sgns_chunk.launches
        client.close()
        return out
    finally:
        mvt.shutdown()


CLIENT_ROLES = {"ps": client_ps, "apply": client_apply, "bsp": client_bsp,
                "once": client_once, "w2v": client_w2v}


def client_main() -> int:
    """A client process: each job line is a role with its flags (reset in
    between), answered with one RESULT line; ``EXIT`` ends it. It needs no
    card unless a job trains on one."""
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.config import FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard
    while True:
        line = sys.stdin.readline().strip()
        if not line or line == "EXIT":
            return 0
        spec = json.loads(line)
        FLAGS.reset()
        Dashboard.reset()
        for key, value in spec.get("flags", {}).items():
            mvt.set_flag(key, value)
        result = CLIENT_ROLES[spec["role"]](mvt, spec)
        print("RESULT " + json.dumps(result), flush=True)


# -- the server side of each leg ----------------------------------------------

def percentiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def launch_counts(rows) -> dict:
    return {"scatter_add_rows": rows.scatter_add_rows.launches,
            "gather_rows": rows.gather_rows.launches}


def zero_launches(rows) -> None:
    rows.scatter_add_rows.launches = 0
    rows.gather_rows.launches = 0


def serve_ps_leg(mvt, rows, device: str, pool: ClientPool,
                 n_clients: int = SERVE_CLIENTS, rounds: int = SERVE_ROUNDS,
                 num_row: int = ROWS, num_col: int = COLS,
                 batch: int = BATCH, seed: int = 3, init_flags=None):
    """Leg 1: the PS phase's three tables served over TCP to
    ``n_clients`` processes; each table against a host mirror of every
    Add; the stats RPC accounts for every Add sent. ``init_flags`` adds
    runtime flags (phase 15 serves it with a write-ahead log: ``wal_dir``,
    ``wal_sync``; the log's metrics join the result)."""
    from multiverso_tpu_torch.dashboard import Dashboard
    mvt.init(device=device, remote_workers=n_clients, heartbeat_seconds=0,
             **(init_flags or {}))
    try:
        mat, ada, arr = ps_tables(mvt, num_row, num_col)
        ep = mvt.serve("127.0.0.1:0")
        spec = dict(role="ps", endpoint=ep, rounds=rounds, seed=seed,
                    num_row=num_row, num_col=num_col, batch=batch,
                    flags={"heartbeat_seconds": 0})
        results = run_jobs(pool.take(n_clients),
                           [dict(spec, idx=i) for i in range(n_clients)],
                           reset=lambda: (zero_launches(rows),
                                          Dashboard.reset()))
        launches = launch_counts(rows)
        snap = mvt.stats(ep)       # the slot-free stats probe
        sent = sum(r["adds"] for r in results)
        mon = snap.monitors.get("SERVER_PROCESS_ADD_MSG", {}).get("count", 0)
        fused = snap.counter("APPLY_FUSED_CALLS")
        batched = snap.counter("APPLY_BATCHED_MSGS")
        # a fused apply is one monitor entry for `batched` Adds
        if mon - fused + batched != sent:
            raise AssertionError(
                f"SERVER_PROCESS_ADD_MSG {mon} (fused calls {fused} of "
                f"{batched} Adds) does not account for the {sent} Adds sent")
        mirror = np.zeros((num_row, num_col), np.float64)
        ada_mirror = np.zeros((num_row, num_col), np.float32)
        for i in range(n_clients):
            g_sqr = np.zeros((num_row, num_col), np.float32)
            for k in range(rounds):
                ids, vals, _ = ps_round(seed, i, k, num_row, num_col, batch)
                np.add.at(mirror, ids, vals)
                if k < rounds // 4:
                    adagrad_mirror(ada_mirror, g_sqr, ids, vals, 0.1, 0.1)
            del g_sqr
        arr_mirror = np.full(num_row, sum(i + k for i in range(n_clients)
                                          for k in range(rounds // 4)),
                             np.float32)
        for name, table, want in (("matrix", mat, mirror),
                                  ("adagrad matrix", ada, ada_mirror),
                                  ("array", arr, arr_mirror)):
            np.testing.assert_allclose(
                table.get(), want, rtol=RTOL, atol=ATOL,
                err_msg=f"served {name} table != host mirror")
        del mirror, ada_mirror
        adds = [x for r in results for x in r["add_us"]]
        gets = [x for r in results for x in r["get_us"]]
        wall = max(r["end"] for r in results) - min(r["start"] for r in results)
        # where a served Add's time goes: the client's codec, this
        # process's frame and codec work, the dispatcher's apply
        server_ms = {name: snap.monitors.get(name, {}).get("average_ms")
                     for name in ("WIRE_DECODE", "WIRE_ENCODE",
                                  "SERVER_PROCESS_ADD_MSG",
                                  "SERVER_PROCESS_GET_MSG")}
        for name in ("FRAME_DECODE_SECONDS", "FRAME_ENCODE_SECONDS"):
            h = snap.histogram(name)
            server_ms[name + "_p50"] = (h.p50 * 1e3 if h is not None
                                        else None)
        client_ms = {name: float(np.mean([r["client_wire_ms"][name]
                                          for r in results]))
                     for name in ("WIRE_ENCODE", "WIRE_DECODE")}
        out = {"clients": n_clients, "matrix_adds": len(adds),
               "adds_per_s": len(adds) / wall, "seconds": wall,
               "add_us": percentiles(adds), "get_us": percentiles(gets),
               "adds_sent": sent, "server_process_add_msg": mon,
               "fused_calls": fused, "fused_adds": batched,
               "dedup_hits": snap.counter("SERVER_DEDUP_HITS"),
               "server_ms": server_ms, "client_ms": client_ms}
        if mvt.wal_writer() is not None:
            out["wal"] = wal_metrics(mvt, snap, sent, wall)
        return out, launches
    finally:
        stop_runtime(mvt)


def serve_apply_leg(mvt, device: str, pool: ClientPool, scratch: str,
                    shm: bool, batch_msgs: int, num_row: int = APPLY_ROWS,
                    num_col: int = APPLY_COLS, adds: int = APPLY_ADDS,
                    producers: int = APPLY_PRODUCERS,
                    window: int = APPLY_WINDOW, batch: int = BATCH) -> dict:
    """Leg 2: bench_apply_path's served Adds from one client process with
    ``producers`` threads; the table bitwise against its mirror. Ring
    segments go to ``scratch``, never to a directory other runs share."""
    from multiverso_tpu_torch.dashboard import Dashboard
    mvt.init(device=device, remote_workers=1, wire_shm=shm,
             wire_shm_dir=scratch, apply_batch_msgs=batch_msgs,
             heartbeat_seconds=0)
    try:
        table = mvt.create_table("matrix", num_row, num_col)
        ep = mvt.serve("127.0.0.1:0")
        spec = dict(role="apply", endpoint=ep, adds=adds, producers=producers,
                    window=window, num_row=num_row, num_col=num_col,
                    batch=batch, flags={"wire_shm": shm,
                                        "wire_shm_dir": scratch,
                                        "heartbeat_seconds": 0})
        (res,) = run_jobs(pool.take(1), [spec], reset=Dashboard.reset)
        snap = mvt.stats(ep)
        mirror = np.zeros((num_row, num_col), np.float32)
        sets = apply_sets(num_row, num_col, batch)
        for i in range(res["per_producer"]):
            ids, vals = sets[i % APPLY_SETS]
            mirror[ids] += producers * vals
        if not np.array_equal(table.get(), mirror):
            raise AssertionError(f"served apply (shm={shm}, batch "
                                 f"{batch_msgs}): table != mirror")
        fused = snap.counter("APPLY_FUSED_CALLS")
        if (fused > 0) != (batch_msgs > 0):
            raise AssertionError(f"apply_batch_msgs={batch_msgs}: "
                                 f"{fused} fused calls")
        hist = snap.histogram("APPLY_BATCH_ROWS")
        shm_frames = snap.counter("SHM_RX_FRAMES")
        if shm and not shm_frames > 0:
            raise AssertionError("wire_shm: no frame came over the ring")
        return {"transport": "shm" if shm else "tcp",
                "apply_batch_msgs": batch_msgs, "gbps": res["gbps"],
                "process_add_ms": snap.monitors.get(
                    "SERVER_PROCESS_ADD_MSG", {}).get("average_ms"),
                "wire_decode_ms": snap.monitors.get(
                    "WIRE_DECODE", {}).get("average_ms"),
                "adds_per_s": res["adds_per_s"], "adds": res["adds"],
                "apply_batch_rows_p50": (hist.p50 if hist is not None
                                         and hist.count else None),
                "fused_calls": fused,
                "batched_msgs": snap.counter("APPLY_BATCHED_MSGS"),
                "shm_frames_recv": shm_frames}
    finally:
        stop_runtime(mvt)


def serve_bsp_leg(mvt, device: str, pool: ClientPool, scratch: str,
                  victim: bool,
                  num_row: int = ROWS, num_col: int = COLS,
                  batch: int = BATCH, rounds: int = BSP_WIRE_ROUNDS,
                  seed: int = 5) -> dict:
    """Leg 3: BSP over the wire. Without a victim, 2 clients; with one, a
    third client is killed with SIGKILL after its 5th Add (mid-round) and
    the survivors' rounds go on once its lease (2 s) expires."""
    from multiverso_tpu_torch.dashboard import Dashboard
    n = 3 if victim else 2
    adds = [rounds] * 2 + ([BSP_VICTIM_ADDS] if victim else [])
    dump = os.path.join(scratch, f"flight_{time.monotonic_ns()}.jsonl")
    mvt.init(device=device, sync=True, ps_role="server", remote_workers=n,
             lease_seconds=LEASE_S, sync_stall_seconds=0.5,
             flight_recorder_path=dump, heartbeat_seconds=0)
    try:
        table = mvt.create_table("matrix", num_row, num_col)
        ep = mvt.serve("127.0.0.1:0")
        spec = dict(role="bsp", endpoint=ep, seed=seed, num_row=num_row,
                    num_col=num_col, batch=batch, adds=adds,
                    flags={"heartbeat_seconds": 0.5})
        t0 = time.perf_counter()
        procs = pool.take(n)
        for i, p in enumerate(procs):
            p.job(dict(spec, idx=i, victim=(i == 2)))
        for p in procs:
            p.expect("READY")
        Dashboard.reset()
        for p in procs:
            p.send("GO")
        killed = None
        if victim:
            killed = int(procs[2].expect("MIDROUND"))
            pool.drop(procs[2])            # SIGKILL, mid-round
            t_kill = time.perf_counter()
        results = [p.result() for p in procs[:2]]
        t_done = time.perf_counter()       # before any checking
        wall = t_done - t0
        snap = mvt.stats(ep)
        mirror = np.zeros((num_row, num_col), np.float32)
        for w, k_n in enumerate(adds):
            for k in range(k_n):
                ids, vals, _ = bsp_round(seed, w, k, num_row, num_col, batch)
                np.add.at(mirror, ids, vals)
        if not np.array_equal(table.get(), mirror):
            raise AssertionError("BSP over the wire: table != mirror")
        out = {"clients": n, "rounds": rounds, "seconds": wall,
               "gets_checked": sum(r["rounds"] for r in results)}
        if victim:
            evictions = snap.counter("WORKER_EVICTIONS")
            if evictions != 1:
                raise AssertionError(f"WORKER_EVICTIONS {evictions}, not 1")
            with open(dump) as f:
                events = [json.loads(line) for line in f
                          if '"kind": "event"' in line]
            named = [e for e in events if e.get("reason") == "worker_evicted"
                     and e.get("worker") == killed]
            if not named:
                raise AssertionError(f"no flight dump names worker {killed}: "
                                     f"{events}")
            out.update(killed_worker=killed, evictions=evictions,
                       survivors_after_kill_s=t_done - t_kill,
                       flight_events=[e["reason"] for e in events])
        return out
    finally:
        stop_runtime(mvt)


def once_mirror(results, seed: int, num_row: int, num_col: int, batch: int,
                which: str = "acked") -> np.ndarray:
    mirror = np.zeros((num_row, num_col), np.float32)
    for idx, r in enumerate(results):
        for i in r[which]:
            ids, vals = once_add(seed, idx, i, num_row, num_col, batch)
            np.add.at(mirror, ids, vals)
    return mirror


def bitwise_gap(table, mirror) -> float:
    """0.0 when the table equals the mirror bit for bit, else max |diff|."""
    got = table.get()
    return 0.0 if np.array_equal(got, mirror) else float(
        np.abs(got - mirror).max())


def serve_once_leg(mvt, device: str, pool: ClientPool, what: str,
                   flags: dict,
                   client_flags: dict, n_clients: int = SERVE_CLIENTS,
                   adds: int = ONCE_ADDS, window: int = ONCE_WINDOW,
                   num_row: int = APPLY_ROWS, num_col: int = APPLY_COLS,
                   batch: int = BATCH, seed: int = 9) -> dict:
    """Leg 4, one of: reply loss (retransmits through the dedup window),
    backlog shedding, deadlines. The table must equal, bit for bit, the
    mirror of the acknowledged Adds; then a planted fault (an Add applied
    twice, or a shed Add applied) must break that equality."""
    from multiverso_tpu_torch.dashboard import Dashboard
    mvt.init(device=device, remote_workers=n_clients, heartbeat_seconds=0,
             **flags)
    try:
        table = mvt.create_table("matrix", num_row, num_col)
        ep = mvt.serve("127.0.0.1:0")
        spec = dict(role="once", endpoint=ep, adds=adds, window=window,
                    seed=seed, num_row=num_row, num_col=num_col, batch=batch,
                    flags=dict(client_flags, heartbeat_seconds=0))
        results = run_jobs(pool.take(n_clients),
                           [dict(spec, idx=i) for i in range(n_clients)],
                           reset=Dashboard.reset)
        snap = mvt.stats(ep)
        mirror = once_mirror(results, seed, num_row, num_col, batch)
        gap = bitwise_gap(table, mirror)
        if gap:
            raise AssertionError(f"{what}: table != mirror of the acknowledged "
                                 f"Adds (max |diff| {gap})")
        out = {k: sum(len(r[k]) for r in results)
               for k in ("acked", "shed", "expired")}
        out.update(dedup_hits=snap.counter("SERVER_DEDUP_HITS"),
                   shed_adds=snap.counter("SHED_ADDS"),
                   deadline_drops=snap.counter("DEADLINE_EXPIRED_DROPS"),
                   injected=snap.counter("FAULT_INJECTED_DROP"))
        # the planted fault: the check must catch it
        plant = None
        if what == "reply_loss":
            idx = next(i for i, r in enumerate(results) if r["acked"])
            plant = once_add(seed, idx, results[idx]["acked"][0], num_row,
                             num_col, batch)
        elif what == "shedding":
            idx = next((i for i, r in enumerate(results) if r["shed"]), None)
            if idx is not None:
                plant = once_add(seed, idx, results[idx]["shed"][0], num_row,
                                 num_col, batch)
        if plant is not None:
            table.add(plant[1], row_ids=plant[0])
            out["planted_gap"] = bitwise_gap(table, mirror)
            if not out["planted_gap"] > 0:
                raise AssertionError(f"{what}: the planted fault was not seen")
        return out
    finally:
        stop_runtime(mvt)


def serve_w2v_leg(mvt, rows, device: str, pool: ClientPool, w2v=None,
                  timed: int = W2V_WIRE_BLOCKS) -> dict:
    """Leg 5: word2vec through remote proxies. The server holds w_in,
    w_out and the count table on ``device``; a client process trains one
    block on ``device`` and one on the CPU from the same tables (restored
    in between), which must agree; then ``timed`` blocks on ``device``."""
    from multiverso_tpu_torch import convert
    from multiverso_tpu_torch.models.word2vec import PSTrainer
    config, d = w2v_setup(w2v)
    mvt.init(device=device, remote_workers=2, heartbeat_seconds=0)
    try:
        tr = PSTrainer(config, d)
        w_in0, w_out0 = tr.input_table.get(), tr.output_table.get()
        ep = mvt.serve("127.0.0.1:0")
        spec = dict(role="w2v", endpoint=ep, w2v=w2v,
                    flags={"heartbeat_seconds": 0})
        zero_launches(rows)
        card, cpu = pool.take(2)
        card.job(dict(spec, idx=0, device=device, timed=timed))
        card.expect("BLOCK1")
        on_card = (tr.input_table.get(), tr.output_table.get())
        convert.load_state(tr.input_table, w_in0, {})
        convert.load_state(tr.output_table, w_out0, {})
        cpu.job(dict(spec, idx=1, device="cpu", timed=0))
        cpu_res = cpu.result()
        on_cpu = (tr.input_table.get(), tr.output_table.get())
        for got, want, name in zip(on_card, on_cpu, ("w_in", "w_out")):
            np.testing.assert_allclose(
                got, want, rtol=W2V_RTOL, atol=W2V_ATOL,
                err_msg=f"word2vec over the wire: {name}, card != CPU")
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(on_card, on_cpu))
        card.expect("READY")
        card.send("GO")
        res = card.result()
        launches = launch_counts(rows)
        words = int(tr.count_table.get(0))
        # remote proxies have no device IO and no transaction, so the
        # client trains by the pair step: the chain runs no chunk there
        check_sgns_launches("the served client", res["sgns_launches"], 0,
                            device)
        return {"words_per_s": res["words_per_s"], "blocks": res["blocks"],
                "card_vs_cpu_max_abs": err, "loss_block1": res["loss"],
                "loss_block1_cpu": cpu_res["loss"],
                "words_counted": words,
                "client_sgns_launches": res["sgns_launches"]}, launches
    finally:
        stop_runtime(mvt)


def serve_phase(mvt, rows, device: str, card: str, scratch: str,
                sizes=None) -> tuple:
    """Phase 14: the port's tables served to client processes. Returns
    (metrics, launch counts of legs 1 and 5). ``sizes`` shrinks the legs
    for a CPU rehearsal; ``overload`` sets leg 4's backlog limit and
    deadline for it."""
    sz = dict(ps={}, apply={}, bsp={}, once={}, w2v={},
              overload=dict(queue_limit=ONCE_QUEUE_LIMIT,
                            deadline_s=ONCE_DEADLINE_S))
    sz.update(sizes or {})
    over = sz["overload"]
    n_ps = sz["ps"].get("n_clients", SERVE_CLIENTS)
    n_once = sz["once"].get("n_clients", SERVE_CLIENTS)
    t_phase = time.perf_counter()
    metrics, seconds = {}, {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    # one process more than a leg needs: leg 3 kills one
    with ClientPool(max(n_ps, n_once, 2) + 1, scratch) as pool:
        ps, ps_launches = timed("1", serve_ps_leg, mvt, rows, device, pool,
                                **sz["ps"])
        metrics["1_ps_tcp"] = ps
        print(f"served PS rows (leg 1) on {card}: {json.dumps(ps)}; launches "
              f"over the leg: {json.dumps(ps_launches)}", flush=True)
        metrics["2_apply"] = {}
        for shm, batch_msgs in ((True, 64), (True, 0), (False, 64)):
            leg = timed(f"2_{shm}_{batch_msgs}", serve_apply_leg, mvt, device,
                        pool, scratch, shm, batch_msgs, **sz["apply"])
            metrics["2_apply"][f"{leg['transport']}_{batch_msgs}"] = leg
            print(f"served apply path (leg 2) on {card}: {json.dumps(leg)}",
                  flush=True)
        metrics["3_bsp"] = timed("3", serve_bsp_leg, mvt, device, pool,
                                 scratch, False, **sz["bsp"])
        metrics["3_bsp_kill"] = timed("3_kill", serve_bsp_leg, mvt, device,
                                      pool, scratch, True, **sz["bsp"])
        print(f"BSP over the wire (leg 3) on {card}: "
              f"{json.dumps(metrics['3_bsp'])}; with a client killed: "
              f"{json.dumps(metrics['3_bsp_kill'])}", flush=True)
        once = metrics["4_once"] = {}
        for what, flags, client_flags in (
                ("reply_loss", dict(fault_spec="drop:type=Reply_Add,every=7"),
                 dict(request_retry_seconds=0.2)),
                ("shedding",
                 dict(admission_queue_limit=over["queue_limit"]), {}),
                ("deadlines", {},
                 dict(request_deadline_seconds=over["deadline_s"]))):
            once[what] = timed(f"4_{what}", serve_once_leg, mvt, device, pool,
                               what, flags, client_flags, **sz["once"])
        print(f"exactly-once and overload (leg 4) on {card}: "
              f"{json.dumps(once)}", flush=True)
        for what, keys in (("reply_loss", ("dedup_hits", "acked")),
                           ("shedding", ("shed", "acked")),
                           ("deadlines", ("deadline_drops", "acked"))):
            for key in keys:
                if not once[what][key] > 0:
                    raise AssertionError(f"leg 4 {what}: {key} is 0")
        w2v, w2v_launches = timed("5", serve_w2v_leg, mvt, rows, device, pool,
                                  **sz["w2v"])
        metrics["5_word2vec"] = w2v
        print(f"word2vec through remote proxies (leg 5) on {card}: "
              f"{json.dumps(w2v)}; launches over the leg: "
              f"{json.dumps(w2v_launches)}", flush=True)
    metrics["leg_s"] = seconds
    metrics["phase_s"] = time.perf_counter() - t_phase
    return metrics, {"1_ps_tcp": ps_launches, "5_word2vec": w2v_launches}


# -- 15. durable serving -------------------------------------------------------
# The write-ahead log, crash recovery, warm-standby failover, read replicas
# and the audit digest, at configuration 1's width (the PS phase's three
# tables). Primaries that must die are child processes of this script
# (``--durable-primary``) on the same card; the standby, the replica and
# every recovered primary run in this process.

WAL_ROUNDS = 32                   # leg 1: rounds per client and sync level
DURABLE_ROUNDS = 12               # leg 2: rounds of the one client
DURABLE_CRASH_ROUND = 2           # leg 2: primary A dies logging this round
DURABLE_SNAP_ROUND = 6            # leg 2: the snapshot, before this round
DURABLE_HANDOVER_ROUND = 8        # leg 2: primary B serves from this round
DURABLE_BATCH = 3                 # leg 2: B's held micro-batch of Adds
FAILOVER_ROUNDS = 8               # leg 3: rounds per client
FAILOVER_CLIENTS = 2
FAILOVER_HALF = 3                 # leg 3: acknowledged rounds before the kill
STANDBY_LEASE_S = 2.0
READ_BUDGET = 32                  # leg 4: read_staleness_records
# leg 4's worker slots, on the primary and its replica alike: the writer, a
# reader, and the slot of the reader before it, whose deregistration (fire
# and forget) may still be in flight when the next reader registers
READ_SLOTS = 3
READ_ADDS = 96                    # leg 4: the writer's Adds
READ_GETS = 64                    # leg 4: Gets per read preference
PRIMARY_S = 180                   # a durable primary's limit for a step


def wal_metrics(mvt, snap, sent: int, wall: float) -> dict:
    """The log's side of a served leg: every Add appended once, its bytes
    and rate, the append and fsync medians (µs)."""
    wal = mvt.wal_writer()
    appends = snap.counter("WAL_APPENDS")
    if appends != sent:
        raise AssertionError(f"WAL_APPENDS {appends} != the {sent} Adds "
                             "sent (each acknowledged Add is logged once)")
    wal_dir = os.path.join(wal.directory, "wal")
    nbytes = sum(os.path.getsize(os.path.join(wal_dir, n))
                 for n in os.listdir(wal_dir))
    out = {"sync": wal.sync, "appends": appends, "bytes": nbytes,
           "mb_per_s": nbytes / wall / 1e6}
    for name in ("WAL_APPEND_SECONDS", "WAL_FSYNC_SECONDS"):
        h = snap.histogram(name)
        out[name.lower()[:-8] + "_p50_us"] = (h.p50 * 1e6 if h is not None
                                               else None)
    return out


def free_port() -> int:
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def arm_crash(point: str, at: int) -> None:
    """Make this process die with ``os._exit(9)`` at ``point`` of the
    ``at``-th wire Add: ``after_append`` (logged, neither applied nor
    acknowledged) or ``mid_batch`` (the ``at``-th fused apply: every Add
    of the micro-batch logged, none applied or acknowledged). The hooks
    patch the port's dispatcher seams, as tests/durable_primary_child.py
    does the JAX package's."""
    from multiverso_tpu_torch.runtime.server import Server
    state = {"n": 0}
    if point == "after_append":
        orig = Server._wal_append

        def hooked(self, msg):
            logged = getattr(msg, "_wal", None) is not None and self.wal
            orig(self, msg)
            if logged:
                state["n"] += 1
                if state["n"] == at:
                    os._exit(9)

        Server._wal_append = hooked
    elif point == "mid_batch":
        orig_fused = Server._apply_fused

        def hooked_fused(self, table, request):
            state["n"] += 1
            if state["n"] == at:
                os._exit(9)
            orig_fused(self, table, request)

        Server._apply_fused = hooked_fused
    else:
        raise SystemExit(f"unknown crash point {point!r}")


def arm_batch_hold(mvt, n: int) -> None:
    """From now on the dispatcher drains only once ``n`` messages are
    queued: the next ``n`` Adds of one table ride one fused apply. A no-op
    request moves the dispatcher off the drain it is blocked in."""
    from multiverso_tpu_torch.runtime.zoo import Zoo
    from multiverso_tpu_torch.utils import MtQueue
    orig = MtQueue.pop_all

    def held(self):
        while self.alive and self.size() < n:
            time.sleep(0.002)
        return orig(self)

    MtQueue.pop_all = held
    Zoo.instance().server.run_serialized(lambda: None)


def durable_primary_main(argv) -> int:
    """``chip_smoke.py --durable-primary PORT WAL_DIR [options]``: serve
    the PS phase's three tables with a write-ahead log on ``127.0.0.1:PORT``
    and print ``serving <endpoint>``; ``--recover`` replays WAL_DIR first
    (and prints ``recovered <json>``); ``--crash-point``/``--crash-at`` and
    ``--batch-hold`` arm a crash (``arm_crash``). Then it serves until
    killed, or until ``EXIT`` on stdin."""
    parser = argparse.ArgumentParser()
    parser.add_argument("port")
    parser.add_argument("wal_dir")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-row", type=int, default=ROWS)
    parser.add_argument("--num-col", type=int, default=COLS)
    parser.add_argument("--remote-workers", type=int, default=1)
    parser.add_argument("--sync", action="store_true")
    parser.add_argument("--recover", action="store_true")
    parser.add_argument("--crash-point", default="")
    parser.add_argument("--crash-at", type=int, default=0)
    parser.add_argument("--batch-hold", type=int, default=0)
    a = parser.parse_args(argv)
    torch.set_num_threads(1)
    import multiverso_tpu_torch as mvt
    mvt.init(device=a.device, ps_role="server",
             remote_workers=a.remote_workers, wal_dir=a.wal_dir,
             sync=a.sync, heartbeat_seconds=0.2, lease_seconds=30.0)
    tables = ps_tables(mvt, a.num_row, a.num_col)
    if a.recover:
        t0 = time.perf_counter()
        result = mvt.durable_recover(tables)
        print("recovered " + json.dumps({
            "seconds": time.perf_counter() - t0,
            "tables_restored": result.tables_restored,
            "records_replayed": result.records_replayed}), flush=True)
    if a.batch_hold:
        arm_batch_hold(mvt, a.batch_hold)
    if a.crash_point:
        arm_crash(a.crash_point, a.crash_at)
    print(f"serving {mvt.serve(f'127.0.0.1:{a.port}')}", flush=True)
    for line in sys.stdin:
        if line.strip() == "EXIT":
            break
    mvt.shutdown()
    return 0


def spawn_primary(scratch: str, name: str, port: int, wal_dir: str,
                  device: str, num_row: int, num_col: int, *extra) -> Client:
    return Client(scratch, 0, name=name, args=(
        "--durable-primary", str(port), wal_dir, f"--device={device}",
        f"--num-row={num_row}", f"--num-col={num_col}", *extra))


def await_exit(proc: Client, code: int, timeout: float = PRIMARY_S) -> float:
    """Wait for a primary's death; its exit code must be ``code``; returns
    the instant (perf_counter) it was seen dead."""
    got = proc.proc.wait(timeout=timeout)
    seen = time.perf_counter()
    proc.killed = True
    if got != code:
        raise AssertionError(f"{proc.name} exited {got}, not {code}\n"
                             f"{proc._tail()}")
    return seen


def durable_rounds(seed: int, rounds: int, num_row: int, num_col: int,
                   batch: int) -> list:
    """Leg 2's Adds, integer-valued: per round a default-matrix Add, an
    AdaGrad Add (ids with duplicates) and a whole-array Add."""
    out = []
    for k in range(rounds):
        rng = np.random.default_rng([seed, k, 15])
        out.append((rng.integers(0, num_row, batch).astype(np.int32),
                    int_rows(rng, (batch, num_col)),
                    rng.integers(0, num_row, batch).astype(np.int32),
                    int_rows(rng, (batch, num_col)),
                    int_rows(rng, (num_row,))))
    return out


def durable_recovery_leg(mvt, rows, device: str, scratch: str,
                         num_row: int = ROWS, num_col: int = COLS,
                         batch: int = BATCH, rounds: int = DURABLE_ROUNDS,
                         seed: int = 5) -> tuple:
    """Leg 2: primary A (a child) dies after logging round 2's first Add;
    this process re-creates the tables, recovers and serves on A's port
    while the client's retransmit settles against the seeded dedup window;
    a durable snapshot mid-run; primary B (a child) recovers from that
    generation plus the log suffix and dies between a fused micro-batch's
    appends and its apply; this process recovers again. Every table
    bitwise equal to a mirror of every acknowledged Add."""
    from multiverso_tpu_torch import checkpoint
    root = os.path.join(scratch, "durable2")
    port = free_port()
    ep = f"127.0.0.1:{port}"
    plan = durable_rounds(seed, rounds, num_row, num_col, batch)
    out = {"rounds": rounds, "recoveries": []}
    events = {k: threading.Event() for k in ("snap", "snapped", "handover",
                                             "b_serving", "done")}
    errors = []
    crash_at = 3 * DURABLE_CRASH_ROUND + 1
    a = spawn_primary(scratch, "primaryA", port, root, device, num_row,
                      num_col, "--crash-point=after_append",
                      f"--crash-at={crash_at}")
    a.expect("serving", PRIMARY_S)
    # the client's flags; a restart here keeps them (no FLAGS reset until
    # the leg ends): its reconnect loop reads them on every attempt
    client_flags = dict(request_retry_seconds=0.5,
                        reconnect_deadline_seconds=PRIMARY_S,
                        retry_base_seconds=0.1, heartbeat_seconds=0)
    for key, value in client_flags.items():
        mvt.set_flag(key, value)

    def client_run():
        try:
            client = mvt.remote_connect(ep)
            mat, ada, arr = client.table(0), client.table(1), client.table(2)
            opt = mvt.AddOption(worker_id=client.worker_id,
                                learning_rate=0.1, rho=0.1)
            for k, (ids, vals, aids, avals, arow) in enumerate(plan):
                if k == DURABLE_SNAP_ROUND:
                    events["snap"].set()
                    events["snapped"].wait(PRIMARY_S)
                if k == DURABLE_HANDOVER_ROUND:
                    events["handover"].set()
                    events["b_serving"].wait(PRIMARY_S)
                    # B's held drain fuses these; it dies before applying
                    handles = [mat.add_async(vals[j::DURABLE_BATCH],
                                             row_ids=ids[j::DURABLE_BATCH])
                               for j in range(DURABLE_BATCH)]
                    for h in handles:
                        mat.wait(h)
                else:
                    mat.add(vals, row_ids=ids)
                ada.add(avals, row_ids=aids, option=opt)
                arr.add(arow)
            client.close()
        except Exception as exc:  # reported by the leg
            errors.append(exc)
        finally:
            events["done"].set()

    def recover_here(what: str, dead_at: float) -> list:
        mvt.init(device=device, ps_role="server", remote_workers=1,
                 wal_dir=root, heartbeat_seconds=0)
        tables = ps_tables(mvt, num_row, num_col)
        t0 = time.perf_counter()
        result = mvt.durable_recover(tables)
        rec_s = time.perf_counter() - t0
        mvt.serve(ep)
        serving = time.perf_counter()
        out["recoveries"].append({
            "what": what, "recover_s": rec_s,
            "kill_to_serving_s": serving - dead_at,
            "tables_restored": result.tables_restored,
            "records_replayed": result.records_replayed,
            "replay_records_per_s": result.records_replayed / rec_s})
        return tables

    thread = threading.Thread(target=client_run, daemon=True)
    thread.start()
    dead = await_exit(a, 9)
    tables = recover_here("after_append, from the log", dead)
    if not events["snap"].wait(PRIMARY_S):
        raise TimeoutError(f"leg 2: no snapshot round; {errors}")
    t0 = time.perf_counter()
    checkpoint.CheckpointDriver(tables, root, wal=mvt.wal_writer()).snapshot()
    out["snapshot_s"] = time.perf_counter() - t0
    events["snapped"].set()
    if not events["handover"].wait(PRIMARY_S):
        raise TimeoutError(f"leg 2: no handover round; {errors}")
    mvt.shutdown()  # a planned handover: this process's log closes cleanly
    b = spawn_primary(scratch, "primaryB", port, root, device, num_row,
                      num_col, "--recover", "--crash-point=mid_batch",
                      "--crash-at=1", f"--batch-hold={DURABLE_BATCH}")
    out["b_recovery"] = json.loads(b.expect("recovered", PRIMARY_S))
    b.expect("serving", PRIMARY_S)
    events["b_serving"].set()
    dead = await_exit(b, 9)
    for child in (a, b):
        child._err.close()
    tables = recover_here("mid_batch, from the snapshot and the log suffix",
                          dead)
    if not events["done"].wait(PRIMARY_S) or errors:
        raise AssertionError(f"leg 2: the client failed: {errors}")
    thread.join(timeout=30)
    mat_m = np.zeros((num_row, num_col), np.float64)
    ada_m = np.zeros((num_row, num_col), np.float32)
    g_sqr = np.zeros((num_row, num_col), np.float32)
    arr_m = np.zeros(num_row, np.float64)
    for ids, vals, aids, avals, arow in plan:
        np.add.at(mat_m, ids, vals)
        adagrad_mirror(ada_m, g_sqr, aids, avals, 0.1, 0.1)
        arr_m += arow
    for name, table, want in (("matrix", tables[0], mat_m.astype(np.float32)),
                              ("adagrad matrix", tables[1], ada_m),
                              ("array", tables[2], arr_m.astype(np.float32))):
        with mvt.Zoo.instance().admin():
            gap = bitwise_gap(table, want)
        if gap != 0.0:
            raise AssertionError(f"leg 2: recovered {name} table != the "
                                 f"mirror of every acknowledged Add (max "
                                 f"|diff| {gap})")
    stop_runtime(mvt)
    shutil.rmtree(root, ignore_errors=True)
    return out


def failover_round(seed: int, idx: int, k: int, num_row: int, num_col: int,
                   batch: int):
    rng = np.random.default_rng([seed, idx, k, 16])
    return (rng.integers(0, num_row, batch).astype(np.int32),
            int_rows(rng, (batch, num_col)), int_rows(rng, (num_row,)))


def client_failover(mvt, s: dict) -> dict:
    """Leg 3: integer-valued Adds to the default matrix and the array (and,
    under BSP, a Get of each to close the round); after ``half``
    acknowledged rounds ``HALF``, and on at the next ``GO`` (the primary
    is killed between the two, at a round boundary); the wall instant of
    every Add's ACK."""
    client = mvt.remote_connect(s["endpoint"])
    mat, arr = client.table(0), client.table(2)
    wait_go()
    acks = []
    for k in range(s["rounds"]):
        ids, vals, arow = failover_round(s["seed"], s["idx"], k,
                                         s["num_row"], s["num_col"],
                                         s["batch"])
        mat.add(vals, row_ids=ids)
        acks.append(time.time())
        arr.add(arow)
        acks.append(time.time())
        if s["bsp"]:
            mat.get(ids)
            arr.get()
        if k + 1 == s["half"]:
            print("HALF", flush=True)
            if sys.stdin.readline().strip() != "GO":
                raise SystemExit("client: no GO after HALF")
    mat.finish_train()
    client.close()
    return {"acks": acks}


CLIENT_ROLES["failover"] = client_failover


def durable_failover_leg(mvt, rows, device: str, pool: ClientPool,
                         scratch: str, mode: str, primary: Client, port: int,
                         num_row: int = ROWS, num_col: int = COLS,
                         batch: int = BATCH, rounds: int = FAILOVER_ROUNDS,
                         seed: int = 6) -> dict:
    """Leg 3: a warm standby in this process tails ``primary`` (a child,
    serving with ``--sync`` under BSP); 2 client processes train; the
    primary is SIGKILLed after 3 acknowledged rounds. The standby takes
    over the service endpoint, the clients finish, and the final tables
    are bitwise the fault-free sums. The AdaGrad table takes no Adds here:
    two workers' float32 steps would sum in arrival order; leg 2 holds it
    bitwise with one client."""
    from multiverso_tpu_torch.dashboard import Dashboard
    ep = primary.expect("serving", PRIMARY_S)
    bsp = mode == "bsp"
    mvt.init(device=device, ps_role="server", remote_workers=FAILOVER_CLIENTS,
             wal_dir=os.path.join(scratch, f"standby_{mode}"), sync=bsp,
             heartbeat_seconds=0.3)
    try:
        tables = ps_tables(mvt, num_row, num_col)
        t0 = time.perf_counter()
        standby = mvt.warm_standby(ep, f"127.0.0.1:{port}",
                                   lease_seconds=STANDBY_LEASE_S)
        if not standby.synced.wait(PRIMARY_S):
            raise TimeoutError(f"leg 3 {mode}: no state transfer")
        transfer_s = time.perf_counter() - t0
        failovers = Dashboard.counter_value("FAILOVERS")
        procs = pool.take(FAILOVER_CLIENTS)
        spec = dict(role="failover", endpoint=ep, rounds=rounds, seed=seed,
                    num_row=num_row, num_col=num_col, batch=batch, bsp=bsp,
                    half=FAILOVER_HALF,
                    flags=dict(request_retry_seconds=0.5,
                               reconnect_deadline_seconds=90.0,
                               retry_base_seconds=0.1,
                               heartbeat_seconds=0.3))
        for i, p in enumerate(procs):
            p.job(dict(spec, idx=i))
        for p in procs:
            p.expect("READY")
        for p in procs:
            p.send("GO")
        for p in procs:
            p.expect("HALF")
        # the kill lands at a round boundary: the standby's round clocks
        # start at 0 for every worker, which a boundary matches (mid-round,
        # a worker whose Add the dead primary acknowledged would wait in
        # its Get for a round the standby never counted)
        t_kill, t_kill_perf = time.time(), time.perf_counter()
        primary.kill()
        for p in procs:
            p.send("GO")
        if not standby.took_over.wait(PRIMARY_S):
            raise AssertionError(f"leg 3 {mode}: the standby never took over")
        took_over_s = time.perf_counter() - t_kill_perf
        results = [p.result() for p in procs]
        after = [t for r in results for t in r["acks"] if t > t_kill]
        mat_m = np.zeros((num_row, num_col), np.float64)
        arr_m = np.zeros(num_row, np.float64)
        for idx in range(FAILOVER_CLIENTS):
            for k in range(rounds):
                ids, vals, arow = failover_round(seed, idx, k, num_row,
                                                 num_col, batch)
                np.add.at(mat_m, ids, vals)
                arr_m += arow
        with mvt.Zoo.instance().admin():
            for name, table, want in (
                    ("matrix", tables[0], mat_m.astype(np.float32)),
                    ("adagrad matrix", tables[1],
                     np.zeros((num_row, num_col), np.float32)),
                    ("array", tables[2], arr_m.astype(np.float32))):
                gap = bitwise_gap(table, want)
                if gap != 0.0:
                    raise AssertionError(
                        f"leg 3 {mode}: {name} after failover != the "
                        f"fault-free sum (max |diff| {gap})")
        n_failovers = Dashboard.counter_value("FAILOVERS") - failovers
        if n_failovers < 1:
            raise AssertionError(f"leg 3 {mode}: FAILOVERS did not count")
        return {"mode": mode, "clients": FAILOVER_CLIENTS, "rounds": rounds,
                "state_transfer_s": transfer_s,
                "records_applied": standby.records_applied,
                "kill_to_took_over_s": took_over_s,
                "kill_to_first_ack_s": (min(after) - t_kill) if after
                else None, "failovers": n_failovers}
    finally:
        stop_runtime(mvt)


def durable_replica_leg(mvt, rows, device: str, scratch: str,
                        primary: Client, num_row: int = ROWS,
                        num_col: int = COLS, batch: int = BATCH,
                        budget: int = READ_BUDGET, adds: int = READ_ADDS,
                        gets: int = READ_GETS) -> tuple:
    """Legs 4 and 5: a read replica in this process tails ``primary`` (a
    child); a writer thread adds ones to a fixed block of 1024 rows of the
    default matrix (after k Adds the block holds k everywhere), reader
    threads Get the block with ``read_preference`` replica, hedged and
    primary. Every replica-served Get is one primary state (k everywhere)
    with k no more than ``budget`` Adds behind; the primary's Get count
    moves only by the readers' primary fallbacks; the replica's lag stays
    within the budget. Then the audit (leg 5): the primary and the replica
    digest equal at a common watermark; a corrupt row planted on the
    replica is caught. Returns (metrics, gather launches over leg 4)."""
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.fault.inject import corrupt_table_row
    ep = primary.expect("serving", PRIMARY_S)
    mvt.init(device=device, ps_role="server", remote_workers=READ_SLOTS,
             wal_dir=os.path.join(scratch, "replica"), heartbeat_seconds=0.2,
             read_staleness_records=budget)
    try:
        tables = ps_tables(mvt, num_row, num_col)
        standby = mvt.warm_standby(ep, ep, takeover=False)
        if not standby.synced.wait(PRIMARY_S):
            raise TimeoutError("leg 4: no state transfer")
        read_ep = standby.serve_reads()
        block = np.arange(batch, dtype=np.int32)
        ones = np.ones((batch, num_col), np.float32)
        acked = [0]
        stop = threading.Event()
        lags = []

        def writer():
            # Adds at least ``adds`` times, and on until the replica
            # readers are done: every replica Get races the log's tail
            client = mvt.remote_connect(ep)
            mat = client.table(0)
            while acked[0] < adds or not stop.is_set():
                mat.add(ones, row_ids=block)
                acked[0] += 1
                time.sleep(0.002)
            client.close()

        def gets_of(preference):
            client = (mvt.remote_connect(ep) if preference == "primary" else
                      mvt.remote_connect(ep, read_endpoints=[read_ep],
                                         read_preference=preference))
            mat, lat, stale = client.table(0), [], []
            for _ in range(gets):
                floor = acked[0]
                t0 = time.perf_counter()
                got = mat.get(block)
                lat.append((time.perf_counter() - t0) * 1e6)
                ceiling = acked[0] + 1          # one Add may be in flight
                k = float(got[0, 0])
                if not (np.array_equal(got, np.full_like(got, k))
                        and floor - budget <= k <= ceiling):
                    raise AssertionError(
                        f"leg 4 {preference}: a Get is no primary state "
                        f"within the budget (k {k}, acked {floor}..{ceiling},"
                        f" budget {budget})")
                stale.append(floor - k)
                lags.append(standby.lag_records())
            client.close()
            return {"get_us": percentiles(lat),
                    "max_records_behind": float(max(stale))}

        def primary_gets():
            h = mvt.stats(ep).histogram("SERVER_PROCESS_GET_MSG")
            return h.count if h is not None else 0

        zero_launches(rows)
        fallbacks0 = Dashboard.counter_value("READ_PRIMARY_FALLBACKS")
        gets0 = primary_gets()
        out = {"budget": budget}
        w = threading.Thread(target=writer, daemon=True)
        w.start()
        for preference in ("replica", "hedged"):
            out[preference] = gets_of(preference)
        fallbacks = (Dashboard.counter_value("READ_PRIMARY_FALLBACKS")
                     - fallbacks0)
        # a hedge's primary Get is not cancelled when the replica answers
        # first: the last ones may still be queued on the primary here
        moved, deadline = primary_gets() - gets0, time.monotonic() + PRIMARY_S
        while moved < fallbacks and time.monotonic() < deadline:
            time.sleep(0.05)
            moved = primary_gets() - gets0
        if moved != fallbacks:
            raise AssertionError(f"leg 4: the primary served {moved} Gets, "
                                 f"the readers fell back {fallbacks} times")
        launches = launch_counts(rows)
        out["primary"] = gets_of("primary")
        stop.set()
        w.join(timeout=PRIMARY_S)
        if w.is_alive():
            raise TimeoutError("leg 4: the writer did not finish")
        out["adds"] = acked[0]
        out["primary_fallbacks"] = fallbacks
        out["replica_served"] = Dashboard.counter_value("READS_SERVED_REPLICA")
        out["lag_records"] = {"max": max(lags), "p50": float(np.median(lags))}
        if max(lags) > budget:
            raise AssertionError(f"leg 4: replica lag {max(lags)} > budget")

        # leg 5: the audit at a common watermark, then a planted fault
        deadline = time.monotonic() + PRIMARY_S
        while (standby.lag_records()
               or standby.applied_watermark < acked[0]) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        fleet = {"endpoints": [ep], "replicas": [[read_ep]]}
        t0 = time.perf_counter()
        report = mvt.audit(fleet, interval=0).check()
        audit_s = time.perf_counter() - t0
        if not report["ok"] or report["skews"] or report["unreachable"]:
            raise AssertionError(f"leg 5: the clean audit failed: {report}")
        if not standby._run(lambda: corrupt_table_row(tables[0], 7)):
            raise AssertionError("leg 5: the corrupt row was not planted")
        report = mvt.audit(fleet, interval=0).check()
        caught = Dashboard.counter_value("AUDIT_DIVERGENCE")
        if report["ok"] or caught < 1:
            raise AssertionError(f"leg 5: the planted fault went uncaught: "
                                 f"{report}")
        out["audit"] = {"check_s": audit_s, "watermark": acked[0],
                        "divergence_caught": caught}
        standby.stop()
        return out, launches
    finally:
        stop_runtime(mvt)


def durable_phase(mvt, rows, device: str, card: str, scratch: str,
                  ps_leg: dict, sizes=None) -> tuple:
    """Phase 15: durable serving at configuration 1's width. ``ps_leg`` is
    phase 14 leg 1's result (no WAL), reported beside leg 1's. Returns
    (metrics, launch counts of legs 2-3 and of leg 4). ``sizes`` shrinks
    the legs for a CPU rehearsal."""
    sz = dict(num_row=ROWS, num_col=COLS, batch=BATCH, wal_rounds=WAL_ROUNDS,
              clients=SERVE_CLIENTS)
    sz.update(sizes or {})
    dims = dict(num_row=sz["num_row"], num_col=sz["num_col"],
                batch=sz["batch"])
    t_phase = time.perf_counter()
    metrics, seconds = {}, {}
    with ClientPool(max(sz["clients"], FAILOVER_CLIENTS), scratch) as pool:
        t0 = time.perf_counter()
        leg1 = metrics["1_wal"] = {"no_wal_phase14": {
            k: ps_leg[k] for k in ("adds_per_s", "add_us", "get_us")}}
        for sync in ("batch", "always"):
            root = os.path.join(scratch, f"wal_{sync}")
            leg, _ = serve_ps_leg(
                mvt, rows, device, pool, n_clients=sz["clients"],
                rounds=sz["wal_rounds"], init_flags=dict(
                    wal_dir=root, wal_sync=sync), **dims)
            shutil.rmtree(root, ignore_errors=True)
            leg1[sync] = {k: leg[k] for k in ("adds_per_s", "add_us",
                                              "get_us", "matrix_adds",
                                              "wal")}
        seconds["1"] = time.perf_counter() - t0
        print(f"WAL cost (leg 1) on {card}: {json.dumps(leg1)}", flush=True)

        # the later legs' primaries start together, while leg 2 runs
        ports = {k: free_port() for k in ("async", "bsp", "replica")}
        prims = {k: spawn_primary(
            scratch, f"primary_{k}", ports[k], os.path.join(scratch, f"p_{k}"),
            device, sz["num_row"], sz["num_col"],
            f"--remote-workers={READ_SLOTS if k == 'replica' else 2}",
            *(("--sync",) if k == "bsp" else ())) for k in ports}
        try:
            t0 = time.perf_counter()
            zero_launches(rows)
            metrics["2_recovery"] = durable_recovery_leg(mvt, rows, device,
                                                         scratch, **dims)
            seconds["2"] = time.perf_counter() - t0
            print(f"crash recovery (leg 2) on {card}: "
                  f"{json.dumps(metrics['2_recovery'])}", flush=True)
            for mode in ("async", "bsp"):
                t0 = time.perf_counter()
                metrics[f"3_failover_{mode}"] = durable_failover_leg(
                    mvt, rows, device, pool, scratch, mode, prims[mode],
                    ports[mode], **dims)
                seconds[f"3_{mode}"] = time.perf_counter() - t0
                print(f"warm-standby failover (leg 3, {mode}) on {card}: "
                      f"{json.dumps(metrics[f'3_failover_{mode}'])}",
                      flush=True)
            replay_launches = launch_counts(rows)
            t0 = time.perf_counter()
            metrics["4_5_replica_audit"], read_launches = durable_replica_leg(
                mvt, rows, device, scratch, prims["replica"], **dims)
            seconds["4_5"] = time.perf_counter() - t0
            print(f"read replicas and audit (legs 4-5) on {card}: "
                  f"{json.dumps(metrics['4_5_replica_audit'])}", flush=True)
        finally:
            for p in prims.values():
                if p.proc.poll() is None:
                    p.kill()
                p._err.close()
    metrics["leg_s"] = seconds
    metrics["phase_s"] = time.perf_counter() - t_phase
    return metrics, {"2_3_recovery_and_standby": replay_launches,
                     "4_replica_reads": read_launches}


# -- 16. sharded serving ------------------------------------------------------
# Configuration 1's three tables range-sharded over two serving processes on
# this card (``mvt.serve_sharded(..., device=...)``); this script and its
# client processes are routers (``ShardedClient``) that hold no table state.
# The row kernels launch in the shard processes: each writes its launch
# counts when the group stops it (``ShardGroup.kernel_launches``).

SHARDS = 2
SHARD_CLIENTS = 4                 # leg 1: client processes
SHARD_ROUNDS = 32                 # leg 1: rounds per client
SHARD_WORKERS = SHARD_CLIENTS + 2  # + leg 2's two router clients
SHARD_QUERY_VECS, SHARD_QUERY_K = 16, 16
MIGRATE_PAUSE_S = 1.0             # leg 2: writing before, between, after
SHARD_HALF = 16                   # leg 4: writer rounds before the kill
SHARD_AFTER = 8                   # leg 4: spanning rounds after the kill
SHARD_SOLO = 6                    # leg 4: shard-0-only Adds in the window
SHARD_READ_GETS = 32              # leg 4: replica-preferred Gets
SHARD_READ_BUDGET = 32            # leg 4: read_staleness_records
GROUP_S = 240                     # a group's start limit
# the children's runtime flags: heartbeats of 0.2 s and a 2 s lease (a
# standby takes over about 2.5 s after its primary dies)
SHARD_GROUP_FLAGS = dict(heartbeat_seconds=0.2, lease_seconds=2.0)


def shard_specs(num_row: int, num_col: int) -> list:
    """Configuration 1's tables as a shard group declares them (the order
    of ``ps_tables``)."""
    return [{"kind": "matrix", "num_row": num_row, "num_col": num_col},
            {"kind": "matrix", "num_row": num_row, "num_col": num_col,
             "updater_type": "adagrad"},
            {"kind": "array", "size": num_row}]


def shard_round(seed: int, idx: int, k: int, clients: int, num_row: int,
                num_col: int, batch: int):
    """Leg 1 client ``idx``'s round ``k``, integer-valued: matrix Add ids
    (duplicates included) and values, Get ids, AdaGrad ids of this
    client's rows only (row % clients == idx, so each row's steps come
    from one worker in its order) and values, an array delta."""
    rng = np.random.default_rng([seed, idx, k, 18])
    return (rng.integers(0, num_row, batch).astype(np.int32),
            int_rows(rng, (batch, num_col)),
            rng.integers(0, num_row, batch).astype(np.int32),
            (idx + clients * rng.integers(0, num_row // clients, batch)
             ).astype(np.int32),
            int_rows(rng, (batch, num_col)),
            int_rows(rng, (num_row,)))


def client_sharded(mvt, s: dict) -> dict:
    """Leg 1: a router client bootstrapped from the group's endpoints;
    ``rounds`` rounds of a 1024-row matrix Add and Get (timed), an
    AdaGrad Add and an array Add."""
    client = mvt.shard_connect(s["endpoints"])
    mat, ada, arr = client.table(0), client.table(1), client.table(2)
    opt = mvt.AddOption(worker_id=client.worker_id, learning_rate=0.1, rho=0.1)
    wait_go()
    add_us, get_us, ada_us, arr_us = [], [], [], []
    start = time.time()
    for k in range(s["rounds"]):
        ids, vals, gids, aids, avals, arow = shard_round(
            s["seed"], s["idx"], k, s["clients"], s["num_row"], s["num_col"],
            s["batch"])
        t0 = time.perf_counter()
        mat.add(vals, row_ids=ids)
        t1 = time.perf_counter()
        got = mat.get(gids)
        t2 = time.perf_counter()
        ada.add(avals, row_ids=aids, option=opt)
        t3 = time.perf_counter()
        arr.add(arow)
        t4 = time.perf_counter()
        add_us.append((t1 - t0) * 1e6)
        get_us.append((t2 - t1) * 1e6)
        ada_us.append((t3 - t2) * 1e6)
        arr_us.append((t4 - t3) * 1e6)
        if got.shape != (s["batch"], s["num_col"]) or not np.isfinite(got).all():
            raise AssertionError(f"bad Get reply {got.shape}")
    end = time.time()
    client.close()
    return {"start": start, "end": end, "add_us": add_us, "get_us": get_us,
            "adagrad_add_us": ada_us, "array_add_us": arr_us,
            "layout_version": client.layout.layout_version}


CLIENT_ROLES["sharded"] = client_sharded


def raw_request(endpoint: str, msg, timeout: float = CLIENT_S):
    """Send one prepared frame to ``endpoint`` over a fresh connection and
    return the reply frame: the same bytes a client's retransmit sends."""
    from multiverso_tpu_torch.runtime.net import TcpNet
    net = TcpNet()
    net.rank = -1
    net.connect([endpoint])
    box, got = {}, threading.Event()

    def pump():
        try:
            while True:
                reply = net.recv()
                if reply is None or reply.msg_id == msg.msg_id:
                    box["reply"] = reply
                    got.set()
                    return
        except ConnectionError:
            got.set()

    threading.Thread(target=pump, daemon=True).start()
    try:
        net.send(msg)
        if not got.wait(timeout):
            raise TimeoutError(f"no reply from {endpoint}")
    finally:
        net.finalize()
    if box.get("reply") is None:
        raise ConnectionError(f"{endpoint} closed before replying")
    return box["reply"]


def group_logs(group) -> str:
    """The last lines of every child's log of ``group`` (quoted when a leg
    fails: the group's directory goes with the scratch directory)."""
    out = []
    for name in sorted(os.listdir(group.base_dir)):
        if name.endswith(".log"):
            with open(os.path.join(group.base_dir, name), errors="replace") as f:
                tail = f.readlines()[-12:]
            out.append(f"--- {name}\n" + "".join(tail))
    return "\n".join(out)


def shard_tables_equal(client, want: dict, what: str) -> None:
    """Whole-table Gets through the router against host mirrors, bitwise
    (``want``: table id -> array)."""
    for table_id, mirror in want.items():
        got = client.table(table_id).get()
        if not np.array_equal(got, mirror.astype(np.float32)):
            diff = float(np.abs(got - mirror).max())
            raise AssertionError(f"{what}: table {table_id} != the mirror of "
                                 f"the acknowledged Adds (max |diff| {diff})")


def shard_leg_serving(mvt, group, pool, sz: dict, seed: int):
    """Leg 1: ``clients`` processes route rounds through ShardedClients;
    every table against the host mirror, bitwise; a second client from one
    endpoint; a top-k query merged across the shards against the oracle.
    Returns (metrics, mirrors, the two router clients)."""
    n, rounds = sz["clients"], sz["rounds"]
    R, C, B = sz["num_row"], sz["num_col"], sz["batch"]
    spec = dict(role="sharded", endpoints=group.endpoints, rounds=rounds,
                seed=seed, clients=n, num_row=R, num_col=C, batch=B,
                flags={"heartbeat_seconds": 0})
    results = run_jobs(pool.take(n), [dict(spec, idx=i) for i in range(n)])
    # where a routed round's time goes, shard by shard: each dispatcher's
    # apply and Get, the log's append, the codec (ms, slot-free stats)
    shard_ms = []
    for ep in group.endpoints:
        snap = mvt.stats(ep)
        ms = {name: snap.monitors.get(name, {}).get("average_ms")
              for name in ("SERVER_PROCESS_ADD_MSG", "SERVER_PROCESS_GET_MSG",
                           "WIRE_DECODE", "WIRE_ENCODE")}
        h = snap.histogram("WAL_APPEND_SECONDS")
        ms["WAL_APPEND_p50"] = h.p50 * 1e3 if h is not None else None
        ms["adds"] = snap.monitors.get("SERVER_PROCESS_ADD_MSG",
                                       {}).get("count", 0)
        shard_ms.append(ms)
    mirror = np.zeros((R, C), np.float64)
    ada_m, g_sqr = np.zeros((R, C), np.float32), np.zeros((R, C), np.float32)
    arr_m = np.zeros(R, np.float64)
    for i in range(n):
        for k in range(rounds):
            ids, vals, _, aids, avals, arow = shard_round(seed, i, k, n, R, C, B)
            np.add.at(mirror, ids, vals)
            adagrad_mirror(ada_m, g_sqr, aids, avals, 0.1, 0.1)
            arr_m += arow
    del g_sqr
    # the routers' requests carry the trace flag: the fleet calls after
    # this leg stitch their spans with the shards'
    mvt.set_flag("trace_requests", True)
    c1 = group.connect()
    c2 = mvt.shard_connect(group.endpoints[-1])  # bootstraps from one member
    t0 = time.perf_counter()
    shard_tables_equal(c1, {0: mirror, 1: ada_m, 2: arr_m}, "leg 1")
    check_s = time.perf_counter() - t0
    probe = np.array([0, R // 2 - 1, R // 2, R - 1], np.int32)
    if not np.array_equal(c2.table(0).get(probe), mirror[probe]):
        raise AssertionError("leg 1: the bootstrapped client reads another "
                             "table")
    rng = np.random.default_rng([seed, 99])
    vecs = rng.standard_normal((SHARD_QUERY_VECS, C)).astype(np.float32)
    t0 = time.perf_counter()
    got = c1.table(0).query(vecs, SHARD_QUERY_K)
    query_ms = (time.perf_counter() - t0) * 1e3
    check_topk(got, topk_oracle(np.arange(R), mirror.astype(np.float32), vecs,
                                SHARD_QUERY_K, "dot"),
               SHARD_QUERY_K, False, "leg 1 routed top-k")
    adds = [x for r in results for x in r["add_us"]]
    gets = [x for r in results for x in r["get_us"]]
    wall = max(r["end"] for r in results) - min(r["start"] for r in results)
    metrics = {"clients": n, "rounds": rounds, "matrix_adds": len(adds),
               "adds_per_s": len(adds) / wall, "seconds": wall,
               "add_us": percentiles(adds), "get_us": percentiles(gets),
               "adagrad_add_us": percentiles(
                   [x for r in results for x in r["adagrad_add_us"]]),
               "array_add_us": percentiles(
                   [x for r in results for x in r["array_add_us"]]),
               "shard_server_ms": shard_ms,
               "whole_table_check_s": check_s,
               # the first query of each shard process starts its BLAS
               "first_query_ms": query_ms}
    return metrics, {0: mirror, 1: ada_m, 2: arr_m}, (c1, c2)


def shard_leg_fleet_obs(mvt, group) -> dict:
    """Leg 1's fleet readout: ``mvt.stats_all``, ``traces``,
    ``attribution``, ``chargeback`` and ``top`` on the group's endpoints,
    each non-empty; the stitched hops causally ordered; the chargeback
    shares summing to 1. Returns each call's ms and sizes."""
    out = {}
    t0 = time.perf_counter()
    merged = mvt.stats_all(group)
    out["stats_all_ms"] = (time.perf_counter() - t0) * 1e3
    adds = merged.monitors.get("SERVER_PROCESS_ADD_MSG", {}).get("count", 0)
    if not adds or merged.unreachable or len(merged.shards) != SHARDS:
        raise AssertionError(f"leg 1 stats_all: {adds} Adds, unreachable "
                             f"{merged.unreachable}")
    out["stats_all_adds"] = adds
    t0 = time.perf_counter()
    spans = mvt.traces(group)
    out["traces_ms"] = (time.perf_counter() - t0) * 1e3
    multi = [sp for sp in spans if len(sp.processes) >= 2]
    if not multi or not all(sp.monotonic() for sp in spans):
        raise AssertionError(f"leg 1 traces: {len(spans)} spans, "
                             f"{len(multi)} across processes, not all in "
                             f"causal order")
    out["spans"], out["spans_across_processes"] = len(spans), len(multi)
    t0 = time.perf_counter()
    report = mvt.attribution(group)
    out["attribution_ms"] = (time.perf_counter() - t0) * 1e3
    if not report.rows or report.dominant is None:
        raise AssertionError("leg 1 attribution: no segments")
    out["dominant_segment"] = report.dominant["segment"]
    out["dominant_share"] = report.dominant["share"]
    t0 = time.perf_counter()
    bill = mvt.chargeback(group)
    out["chargeback_ms"] = (time.perf_counter() - t0) * 1e3
    total = sum(r["share"] for r in bill.rows)
    if not bill.rows or abs(total - 1.0) > 1e-9:
        raise AssertionError(f"leg 1 chargeback: shares sum to {total}")
    out["chargeback_tenants"] = [r["tenant"] for r in bill.rows]
    t0 = time.perf_counter()
    view = mvt.top(group)
    out["top_ms"] = (time.perf_counter() - t0) * 1e3
    if not all(ep in view for ep in group.endpoints):
        raise AssertionError(f"leg 1 top: endpoints missing from\n{view}")
    return out


def shard_leg_migration(mvt, group, clients, mirrors: dict, sz: dict,
                        seed: int) -> dict:
    """Leg 2: a writer thread on each router client adds integer rows to
    the default matrix and the array while ``reshard(group).split(0)``
    and then ``merge(0)`` run; zero acknowledged Adds lost (bitwise),
    every migration completed and none aborted, both clients on the new
    layout."""
    R, C, B = sz["num_row"], sz["num_col"], sz["batch"]
    mirror, arr_m = mirrors[0], mirrors[2]
    lock, stop, errors, counts = threading.Lock(), threading.Event(), [], [0, 0]
    done0 = (mvt.Dashboard.counter_value("MIGRATIONS_COMPLETED"),
             mvt.Dashboard.counter_value("MIGRATIONS_ABORTED"))

    def writer(w, client):
        mat, arr = client.table(0), client.table(2)
        rng = np.random.default_rng([seed, w, 2])
        try:
            while not stop.is_set():
                ids = rng.integers(0, R, B).astype(np.int32)
                vals = int_rows(rng, (B, C))
                arow = int_rows(rng, (R,))
                mat.add(vals, row_ids=ids)
                with lock:
                    np.add.at(mirror, ids, vals)
                arr.add(arow)
                with lock:
                    arr_m[:] += arow
                    counts[w] += 1
        except BaseException as err:  # reported below, never passed over
            errors.append(err)

    threads = [threading.Thread(target=writer, args=(w, c), daemon=True)
               for w, c in enumerate(clients)]
    for t in threads:
        t.start()
    out = {}
    try:
        time.sleep(MIGRATE_PAUSE_S)
        for op in ("split", "merge"):
            before = sum(counts)
            plan = getattr(mvt.reshard(group), op)(0)
            joiners = []
            for j in plan.joiners:
                path = os.path.join(group.base_dir,
                                    f"join-v{plan.new_version}.{j['shard']}.status")
                with open(path) as f:
                    st = json.load(f)
                joiners.append({k: st.get(k) for k in (
                    "records_applied", "transfer_bytes", "transfer_s")})
            out[op] = {"layout_version": plan.new_version,
                       "shards": plan.new_manifest["num_shards"],
                       "start_to_catchup_s": plan.timings["catchup_s"],
                       "start_to_cutover_s": plan.timings["cutover_s"],
                       "start_to_serving_s": plan.timings["serving_s"],
                       "total_s": plan.timings["total_s"],
                       "transfer_mb": sum(j["transfer_bytes"]
                                          for j in joiners) / 1e6,
                       "transfer_s": max(j["transfer_s"] for j in joiners),
                       "records_replayed": sum(j["records_applied"]
                                               for j in joiners),
                       "writer_rounds_during": sum(counts) - before}
            time.sleep(MIGRATE_PAUSE_S)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=CLIENT_S)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError("leg 2: a writer did not stop")
    shard_tables_equal(clients[0], mirrors, "leg 2")
    for c in clients:
        c.table(0).get(np.array([0], np.int32))  # a stale router re-fetches
        if c.layout.layout_version != out["merge"]["layout_version"]:
            raise AssertionError(f"leg 2: a client ends on layout "
                                 f"v{c.layout.layout_version}")
    done = (mvt.Dashboard.counter_value("MIGRATIONS_COMPLETED") - done0[0],
            mvt.Dashboard.counter_value("MIGRATIONS_ABORTED") - done0[1])
    if done != (2, 0):
        raise AssertionError(f"leg 2: migrations completed/aborted {done}, "
                             "want (2, 0)")
    out["writer_rounds"] = sum(counts)
    out["completed"], out["aborted"] = done
    return out


def shard_leg_cut(mvt, group, client, mirrors: dict, sz: dict, scratch: str,
                  device: str, seed: int):
    """Leg 3 (writers paused): an Add sent as a raw frame and acknowledged,
    ``cut_fleet``, an Add after the fence; the group stops;
    ``restore_fleet`` brings a fresh group up on ``device``: every table's
    digest equals the manifest's, the tables equal the mirror at the fence
    bitwise, and the pre-cut Add resent byte for byte is answered from the
    seeded dedup window, not applied. A last routed Add makes the restored
    shards scatter. Returns (metrics, the restored group's launches)."""
    from multiverso_tpu_torch.runtime import wire
    from multiverso_tpu_torch.runtime.message import (Message, MsgType,
                                                      next_msg_id)
    from multiverso_tpu_torch.runtime.remote import fetch_digest
    R, C, B = sz["num_row"], sz["num_col"], sz["batch"]
    rng = np.random.default_rng([seed, 3])
    ids = rng.choice(R // 2, B, replace=False).astype(np.int32)  # shard 0
    vals = int_rows(rng, (B, C))
    pre = Message(src=-1, dst=0, type=MsgType.Request_Add, table_id=0,
                  msg_id=next_msg_id(), req_id=(1 << 62) + seed,
                  data=wire.encode((ids, vals, mvt.AddOption(worker_id=-1))))
    reply = raw_request(group.endpoints[0], pre)
    if reply.type != MsgType.Reply_Add:
        raise AssertionError(f"leg 3: the pre-cut Add got {reply.type}")
    np.add.at(mirrors[0], ids, vals)
    t0 = time.perf_counter()
    manifest = mvt.cut_fleet(group, cut_id="phase16")
    cut_s = time.perf_counter() - t0
    fence = {k: v.copy() for k, v in mirrors.items()}
    client.table(0).add(np.ones((2, C), np.float32),
                        row_ids=np.array([0, R - 1], np.int32))  # after it
    t0 = time.perf_counter()
    restored = mvt.restore_fleet(manifest, device=device, timeout=GROUP_S,
                                 base_dir=os.path.join(scratch, "restored"))
    restore_s = time.perf_counter() - t0
    try:
        digests_equal = 0
        for shard in manifest["shards"]:
            live = fetch_digest(restored.endpoints[int(shard["shard"])],
                                timeout=CLIENT_S)
            want = {int(k): dict(v) for k, v in shard["digests"].items()}
            if {int(k): dict(v) for k, v in live["tables"].items()} != want:
                raise AssertionError(f"leg 3: shard {shard['shard']}'s "
                                     "restored digests != the manifest's")
            digests_equal += len(want)
        again = raw_request(restored.endpoints[0], pre)
        if again.type != MsgType.Reply_Add:
            raise AssertionError(f"leg 3: the retried Add got {again.type}")
        hits = mvt.stats(restored.endpoints[0]).counter("SERVER_DEDUP_HITS")
        if hits < 1:
            raise AssertionError("leg 3: the retry was not a dedup hit")
        rc = restored.connect()
        shard_tables_equal(rc, fence, "leg 3 restored (after the retry)")
        last = np.array([0, R - 1], np.int32)
        rc.table(0).add(np.ones((2, C), np.float32), row_ids=last)
        got = rc.table(0).get(last)
        if not np.array_equal(got, fence[0][last] + 1):
            raise AssertionError("leg 3: an Add on the restored fleet")
        rc.close()
    except BaseException:
        print(group_logs(restored), flush=True)
        raise
    finally:
        restored.stop()
    return ({"cut_s": cut_s, "restore_s": restore_s,
             "fences": [int(s["fence"]) for s in manifest["shards"]],
             "digests_equal": digests_equal, "dedup_hits": hits},
            restored.kernel_launches())


def shard_leg_failover(mvt, sz: dict, scratch: str, device: str, seed: int):
    """Leg 4: a group with a warm standby and a read replica a shard. A
    writer adds ones to a block of rows spanning both shards (and integer
    rows to the array) while a reader Gets the block with
    ``read_preference`` replica; each shard's half of a replica Get is one
    primary state within ``read_staleness_records``. Shard 1's primary is
    SIGKILLed at a round boundary; shard-0-only Adds go on in the window;
    the standby takes over; the final tables equal the fault-free sums
    bitwise; ``FAILOVERS`` is 0 on shard 0 and 1 on shard 1. Returns
    (metrics, the group's launches)."""
    R, C, B = sz["num_row"], sz["num_col"], sz["batch"]
    half = B // 2
    block = np.concatenate([np.arange(half), R // 2 + np.arange(half)]
                           ).astype(np.int32)
    ones = np.ones((B, C), np.float32)
    solo = block[:half]
    group = mvt.serve_sharded(
        shard_specs(R, C), shards=SHARDS, standby=True, replicas=1,
        durable=True, device=device, base_dir=os.path.join(scratch, "leg4"),
        flags=dict(SHARD_GROUP_FLAGS, remote_workers=2))
    from multiverso_tpu_torch.config import FLAGS
    try:
        # this process's routers: the replica budget, and a reconnect
        # deadline past the failover
        mvt.set_flag("read_staleness_records", SHARD_READ_BUDGET)
        mvt.set_flag("reconnect_deadline_seconds", 90.0)
        writer, reader = group.connect(), group.connect(read_preference="replica")
        mat, arr = writer.table(0), writer.table(2)
        mirror = np.zeros((R, C), np.float64)
        arr_m = np.zeros(R, np.float64)
        acked = [0]
        rng = np.random.default_rng([seed, 4])
        stop, lat, behind, errors = threading.Event(), [], [], []

        def write_round(rows, values):
            mat.add(values, row_ids=rows)
            np.add.at(mirror, rows, values)
            arow = int_rows(rng, (R,))
            arr.add(arow)
            arr_m[:] += arow

        def read():
            rmat = reader.table(0)
            try:
                for _ in range(SHARD_READ_GETS):
                    floor = acked[0]
                    t0 = time.perf_counter()
                    got = rmat.get(block)
                    lat.append((time.perf_counter() - t0) * 1e6)
                    ceiling = acked[0] + 1
                    for part in (got[:half], got[half:]):
                        k = float(part[0, 0])
                        if not (np.array_equal(part, np.full_like(part, k))
                                and floor - SHARD_READ_BUDGET <= k <= ceiling):
                            raise AssertionError(
                                f"leg 4: a replica Get is no primary state "
                                f"within the budget (k {k}, acked "
                                f"{floor}..{ceiling})")
                        behind.append(floor - k)
            except BaseException as err:
                errors.append(err)

        r = threading.Thread(target=read, daemon=True)
        r.start()
        for _ in range(SHARD_HALF):
            write_round(block, ones)
            acked[0] += 1
        r.join(timeout=CLIENT_S)
        if errors:
            raise errors[0]
        if r.is_alive():
            raise TimeoutError("leg 4: the reader did not finish")
        # the kill lands at a round boundary (the writer is one thread)
        t_kill = time.perf_counter()
        group.kill_shard(1)
        solo_s = []
        for _ in range(SHARD_SOLO):       # shard 0 alone: never blocked
            t0 = time.perf_counter()
            mat.add(ones[:half], row_ids=solo)
            solo_s.append(time.perf_counter() - t0)
            np.add.at(mirror, solo, ones[:half])
        took = {}
        waiter = threading.Thread(target=lambda: took.update(
            ep=group.wait_failover(1, timeout=GROUP_S),
            s=time.perf_counter() - t_kill), daemon=True)
        waiter.start()
        first_ack = None
        for _ in range(SHARD_AFTER):
            write_round(block, ones)
            if first_ack is None:
                first_ack = time.perf_counter() - t_kill
        waiter.join(timeout=GROUP_S)
        if took.get("ep") != group.endpoints[1]:
            raise AssertionError(f"leg 4: took over at {took.get('ep')}")
        if max(solo_s) >= 2.0:
            raise AssertionError(f"leg 4: shard 0 blocked in the failover "
                                 f"window ({max(solo_s):.2f} s)")
        shard_tables_equal(writer, {0: mirror, 1: np.zeros((R, C)),
                                    2: arr_m}, "leg 4 after the failover")
        failovers = [mvt.stats(ep).counter("FAILOVERS")
                     for ep in group.endpoints]
        if failovers != [0, 1]:
            raise AssertionError(f"leg 4: FAILOVERS by shard {failovers}, "
                                 "want [0, 1]")
        writer.close()
        reader.close()
        metrics = {"replica_get_us": percentiles(lat),
                   "max_records_behind": float(max(behind)),
                   "budget": SHARD_READ_BUDGET,
                   "kill_to_took_over_s": took["s"],
                   "kill_to_first_ack_s": first_ack,
                   "shard0_solo_add_max_s": max(solo_s),
                   "failovers_by_shard": failovers}
    except BaseException:
        print(group_logs(group), flush=True)
        raise
    finally:
        FLAGS.reset()
        group.stop()
    return metrics, group.kernel_launches()


def shard_phase(mvt, device: str, card: str, scratch: str, ps_leg: dict,
                sizes=None) -> tuple:
    """Phase 16: sharded serving at configuration 1's width over
    ``SHARDS`` serving processes on ``device``. ``ps_leg`` is phase 14
    leg 1's result (one unsharded server), reported beside leg 1's.
    Returns (metrics, the shard processes' launch counts by leg and
    role). ``sizes`` shrinks the legs for a CPU rehearsal."""
    sz = dict(num_row=ROWS, num_col=COLS, batch=BATCH, rounds=SHARD_ROUNDS,
              clients=SHARD_CLIENTS)
    sz.update(sizes or {})
    t_phase = time.perf_counter()
    metrics, launches, seconds = {}, {}, {}
    with ClientPool(sz["clients"], scratch) as pool:
        t0 = time.perf_counter()
        group = mvt.serve_sharded(
            shard_specs(sz["num_row"], sz["num_col"]), shards=SHARDS,
            durable=True, device=device, base_dir=os.path.join(scratch, "g"),
            flags=dict(SHARD_GROUP_FLAGS, remote_workers=SHARD_WORKERS))
        seconds["start"] = time.perf_counter() - t0
        clients = ()
        try:
            t0 = time.perf_counter()
            leg1, mirrors, clients = shard_leg_serving(mvt, group, pool, sz,
                                                       7)
            leg1["unsharded_phase14"] = {
                k: ps_leg[k] for k in ("adds_per_s", "add_us", "get_us")}
            leg1["fleet_obs"] = shard_leg_fleet_obs(mvt, group)
            metrics["1_routed"] = leg1
            seconds["1"] = time.perf_counter() - t0
            print(f"sharded serving (leg 1) on {card}: {json.dumps(leg1)}",
                  flush=True)
            t0 = time.perf_counter()
            metrics["2_migration"] = shard_leg_migration(
                mvt, group, clients, mirrors, sz, 8)
            seconds["2"] = time.perf_counter() - t0
            print(f"live split and merge (leg 2) on {card}: "
                  f"{json.dumps(metrics['2_migration'])}", flush=True)
            t0 = time.perf_counter()
            cut, launches["3_restored"] = shard_leg_cut(
                mvt, group, clients[0], mirrors, sz, scratch, device, 9)
            metrics["3_cut"] = cut
            seconds["3"] = time.perf_counter() - t0
            print(f"consistent cut and restore (leg 3) on {card}: "
                  f"{json.dumps(cut)}", flush=True)
        except BaseException:
            print(group_logs(group), flush=True)
            raise
        finally:
            for c in clients:
                c.close()
            group.stop()
        launches["1_2_group"] = group.kernel_launches()
    t0 = time.perf_counter()
    metrics["4_failover"], launches["4_failover"] = shard_leg_failover(
        mvt, sz, scratch, device, 10)
    seconds["4"] = time.perf_counter() - t0
    print(f"per-shard failover with replicas (leg 4) on {card}: "
          f"{json.dumps(metrics['4_failover'])}", flush=True)
    metrics["leg_s"] = seconds
    metrics["phase_s"] = time.perf_counter() - t_phase
    return metrics, launches


def check_shard_launches(launches: dict) -> dict:
    """Phase 16's kernel readout: the scatter and the gather launched in
    every shard primary of legs 1-2 (``shard<k>``), the scatter in every
    joiner (``join-v<version>.<k>``) and in every restored shard, the
    gather in every replica. Returns the counts by role."""
    out = {}
    g = launches["1_2_group"]
    for role in ("shard0", "shard1"):
        for k in ("scatter_add_rows", "gather_rows"):
            if g[role][k] <= 0:
                raise AssertionError(f"{k}: no launch in leg 1's {role}")
    joiners = [r for r in g if r.startswith("join-")]
    if len(joiners) != 3:
        raise AssertionError(f"leg 2: {len(joiners)} joiner readouts, want 3")
    checks = [(f"leg 2 {r}", g[r], "scatter_add_rows") for r in joiners]
    checks += [(f"leg 3 restored {r}", launches["3_restored"][r],
                "scatter_add_rows") for r in ("shard0", "shard1")]
    checks += [(f"leg 4 {r}", launches["4_failover"][r], "gather_rows")
               for r in ("replica0.0", "replica1.0")]
    for what, counts, k in checks:
        if counts[k] <= 0:
            raise AssertionError(f"{k}: no launch in {what}")
    for leg, roles in launches.items():
        for role, counts in roles.items():
            out[f"{leg}/{role}"] = {k: counts[k] for k in (
                "scatter_add_rows", "gather_rows")}
    return out


# -- 17. LDA -------------------------------------------------------------------
# PSGibbsLDA (models/lda.py) at the UCI Bag-of-Words NYTimes corpus's shape:
# vocabulary 102,660, 332 tokens a document (its mean: 99.5 M tokens over
# 299,752 documents), 1,000 topics, alpha = 50/K and beta = 0.01 (Griffiths
# & Steyvers, PNAS 2004). The corpus is planted-topic synthetic at that
# shape (NYTimes is not in the repo): 4 worker threads of 256 documents
# each share one 102,660 x 1,000 word-topic matrix table and one topic
# total array table on the card.

LDA_VOCAB, LDA_TOPICS, LDA_DOC_LEN = 102_660, 1_000, 332
LDA_WORKERS, LDA_DOCS_PER_WORKER, LDA_SWEEPS = 4, 256, 10
LDA_ALPHA, LDA_BETA = 50.0 / LDA_TOPICS, 0.01
LDA_SEED = 11
# the near-tie rule of the card against the CPU: the two best scores of a
# token within this of each other (float64) may swap between two logs
LDA_TIE = 1e-5
# tests/test_lda.py's planted-topic case, and examples/lda_topics.py's run
LDA_PLANTED = dict(vocab=60, topics=3, docs=60, doc_len=40, seed=1,
                   sweeps=20, bar=0.9)
LDA_EXAMPLE_BAR = 0.8
LDA_PARITY_SWEEPS = 3
# a worker's pull: about 25,500 distinct words of its 256 documents
# (run 53), padded to this bucket
LDA_PULL_BUCKET = 32_768


def lda_draw_hook(seed: int):
    """Uniform draws in [1e-10, 1) from numpy, the same on every device."""
    def hook(i, shape):
        u = np.random.default_rng([seed, i]).random(shape, dtype=np.float32)
        return np.maximum(u * np.float32(1 - 1e-10) + np.float32(1e-10),
                          np.float32(1e-10))
    return hook


def lda_mirror(workers, vocab: int, topics: int) -> np.ndarray:
    """The word-topic counts implied by every worker's assignments."""
    implied = np.zeros((vocab, topics), np.float32)
    for w in workers:
        live = w.tokens >= 0
        np.add.at(implied, (w.tokens[live], w.z[live]), 1.0)
    return implied


def lda_check_counts(workers, what: str) -> int:
    """The word-topic table bitwise equal to the mirror of every worker's
    assignments, the topic totals to its column sums, the grand total to
    the live tokens. Returns the live tokens."""
    cfg = workers[0].config
    wt = workers[0].word_topic_counts()
    if not np.array_equal(wt, lda_mirror(workers, cfg.vocab_size,
                                          cfg.num_topics)):
        raise AssertionError(f"{what}: the word-topic table differs from "
                             f"the assignment mirror")
    nk = np.asarray(workers[0].topic_counts.get())[: cfg.num_topics]
    if not np.array_equal(nk, wt.sum(axis=0)):
        raise AssertionError(f"{what}: the topic totals differ from the "
                             f"table's column sums")
    live = int(sum(int((w.tokens >= 0).sum()) for w in workers))
    if float(wt.sum(dtype=np.float64)) != live:
        raise AssertionError(f"{what}: {float(wt.sum())} counts for {live} "
                             f"tokens")
    return live


def lda_scores(tokens, z, wt, nk, u, cfg) -> np.ndarray:
    """Every token's Gumbel-perturbed log conditional, in float64, from a
    sweep's inputs (the near-tie rule)."""
    K = cfg.num_topics
    live = tokens >= 0
    zoh = np.eye(K)[z] * live[..., None]
    n_dk = zoh.sum(axis=1, keepdims=True) - zoh
    logp = (np.log(n_dk + cfg.alpha) + np.log(wt[np.maximum(tokens, 0)]
                                              + cfg.beta)
            - np.log(nk + cfg.vocab_size * cfg.beta))
    return logp - np.log(-np.log(u.astype(np.float64)))


def lda_parity(mvt, device: str) -> dict:
    """The planted-topic configuration for LDA_PARITY_SWEEPS sweeps on
    ``device`` with the numpy draws: per sweep the assignments before it,
    the tables before it and after it."""
    from multiverso_tpu_torch.models.lda import (LDAConfig, PSGibbsLDA,
                                                 synthetic_corpus)
    p = LDA_PLANTED
    docs, _ = synthetic_corpus(p["vocab"], p["topics"], p["docs"],
                               p["doc_len"], seed=p["seed"])
    mvt.init(device=device)
    try:
        lda = PSGibbsLDA(LDAConfig(p["vocab"], p["topics"], alpha=0.5,
                                   beta=0.1, seed=p["seed"]), docs)
        hook = lda_draw_hook(LDA_SEED)
        lda.draw_hook = hook
        out = {"tokens": lda.tokens, "cfg": lda.config, "z": [], "wt": [],
               "nk": [], "u": []}
        for i in range(LDA_PARITY_SWEEPS):
            out["z"].append(lda.z.copy())
            out["wt"].append(lda.word_topic_counts())
            out["nk"].append(np.asarray(lda.topic_counts.get())[:p["topics"]])
            out["u"].append(hook(i, lda.z.shape + (p["topics"],)))
            lda.sweep()
            lda_check_counts([lda], f"{device} parity sweep {i}")
        out["z"].append(lda.z.copy())
        return out
    finally:
        stop_runtime(mvt)


def lda_card_vs_cpu(mvt) -> dict:
    """The planted-topic run on the card and on the CPU from the same
    draws: equal assignments sweep by sweep, except where the CPU's two
    best scores are within LDA_TIE (counted; the runs part there, so the
    comparison stops after that sweep)."""
    card, cpu = lda_parity(mvt, "cuda"), lda_parity(mvt, "cpu")
    ties, compared = 0, 0
    for i in range(LDA_PARITY_SWEEPS):
        bad = np.argwhere(card["z"][i + 1] != cpu["z"][i + 1])
        compared = i + 1
        if len(bad) == 0:
            continue
        scores = lda_scores(cpu["tokens"], cpu["z"][i], cpu["wt"][i],
                            cpu["nk"][i], cpu["u"][i], cpu["cfg"])
        top2 = np.sort(scores, axis=-1)[..., -2:]
        gap = top2[..., 1] - top2[..., 0]
        for b in bad:
            if gap[tuple(b)] >= LDA_TIE:
                raise AssertionError(
                    f"LDA card vs CPU, sweep {i}: token {tuple(b)} differs "
                    f"with a score gap of {gap[tuple(b)]}")
        ties += len(bad)
        break
    return {"sweeps_compared": compared, "near_tie_mismatches": ties}


def lda_planted(mvt, device: str) -> dict:
    """tests/test_lda.py's planted-topic case on ``device``, with the
    port's lockcheck on from before init to after shutdown."""
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.fault import lockcheck
    from multiverso_tpu_torch.models.lda import (LDAConfig, PSGibbsLDA,
                                                 purity, synthetic_corpus)
    p = LDA_PLANTED
    docs, labels = synthetic_corpus(p["vocab"], p["topics"], p["docs"],
                                    p["doc_len"], seed=p["seed"])
    cycles0 = Dashboard.counter_value("LOCK_ORDER_CYCLES")
    lockcheck.enable()
    try:
        mvt.init(device=device)
        try:
            lda = PSGibbsLDA(LDAConfig(p["vocab"], p["topics"], alpha=0.5,
                                       beta=0.1, seed=p["seed"]), docs)
            lda.run(p["sweeps"])
            lda_check_counts([lda], "planted topics")
            score = purity(lda.doc_topics(), labels, p["topics"])
        finally:
            stop_runtime(mvt)
    finally:
        lockcheck.disable()
    cycles = [f for f in lockcheck.take_findings()
              if f["kind"] == "lock_order_cycle"]
    if cycles or Dashboard.counter_value("LOCK_ORDER_CYCLES") != cycles0:
        raise AssertionError(f"LDA planted topics: lock-order cycles "
                             f"{lockcheck.report_text()}")
    if score <= p["bar"]:
        raise AssertionError(f"LDA planted topics: purity {score} <= "
                             f"{p['bar']}")
    return {"purity": score, "lock_order_cycles": 0}


def lda_example(device: str) -> float:
    """examples/lda_topics.py's run through the port's twin of it."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "multiverso_tpu_torch", "examples", "lda_topics.py")
    spec = importlib.util.spec_from_file_location("lda_topics_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    score = module.main(device=device)
    from multiverso_tpu_torch.config import FLAGS
    FLAGS.reset()
    if score <= LDA_EXAMPLE_BAR:
        raise AssertionError(f"LDA example: purity {score} <= "
                             f"{LDA_EXAMPLE_BAR}")
    return score


def lda_sweep_device_ms(lda, iters: int = 5) -> float:
    """CUDA-event ms of one sweep function call on ``lda``'s current
    state (the pull done first, outside the timing)."""
    K = lda.config.num_topics
    words, slots = lda.candidate_slots()
    dev = lda.device
    wt_rows = lda.word_topic.wait_device(
        lda.word_topic.get_device_async(words), words)[:, :K]
    nk = torch.from_numpy(np.asarray(lda.topic_counts.get(),
                                     np.float32)[:K].copy()).to(dev)
    args = (wt_rows, nk, torch.from_numpy(slots).to(dev),
            torch.from_numpy(lda.z).to(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return device_ms(lambda: lda._sweep(*args, generator=gen), iters)


def lda_path_rows(mvt, rows, lda) -> dict:
    """One of the LDA path's pulls and one of its pushes against the plain
    versions of the row kernels, bit for bit, on the same table and the
    same padded ids: the pull's reply against ``gather_rows_plain`` of the
    table before it, the table after a sweep's delta push against
    ``scatter_add_rows_plain``. The delta is then pushed back negated:
    integer counts, so the table is bitwise what it was."""
    from multiverso_tpu_torch.utils import next_pow2
    K = lda.config.num_topics
    wt = lda.word_topic
    words, slots = lda.candidate_slots()
    n, dev = len(words), lda.device

    def padded_ids(bucket):
        ids = np.full(bucket, wt.sentinel_row, np.int32)
        ids[:n] = words
        return torch.from_numpy(ids).to(dev)

    with mvt.worker(0):
        before = wt.get_device()
        pulled = wt.wait_device(wt.get_device_async(words), words)
        pull_ids = padded_ids(max(next_pow2(n + 1), rows.ROW_GROUP))
        if not torch.equal(bits(pulled),
                           bits(rows.gather_rows_plain(before, pull_ids))):
            raise AssertionError("LDA pull: the gathered rows differ from "
                                 "gather_rows_plain on the same table")
        nk = torch.from_numpy(np.asarray(lda.topic_counts.get(),
                                         np.float32)[:K].copy()).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(LDA_SEED)
        _, d_wt, _, _ = lda._sweep(pulled[:, :K], nk,
                                   torch.from_numpy(slots).to(dev),
                                   torch.from_numpy(lda.z).to(dev),
                                   generator=gen)
        delta = d_wt[:n].contiguous()
        wt.wait(wt.add_device_async(delta, words))
        after = wt.get_device()
        push_ids = padded_ids(max(next_pow2(n), rows.ROW_GROUP))
        vals = torch.zeros((len(push_ids), before.shape[1]),
                           dtype=before.dtype, device=dev)
        vals[:n, :K] = delta
        want = rows.scatter_add_rows_plain(before.clone(), push_ids, vals)
        if not torch.equal(bits(after), bits(want)):
            raise AssertionError("LDA push: the table differs from "
                                 "scatter_add_rows_plain on the same delta")
        wt.wait(wt.add_device_async(-delta, words))
        if not torch.equal(bits(wt.get_device()), bits(before)):
            raise AssertionError("LDA push: the negated delta did not "
                                 "restore the table")
    changed = int((delta != 0).sum())
    del before, after, want, vals, pulled, d_wt, delta
    torch.cuda.empty_cache()
    return {"rows": n, "pull_bucket": len(pull_ids),
            "push_bucket": len(push_ids), "delta_nonzeros": changed}


def lda_phase(mvt, rows, device: str, card: str, scratch: str,
              sizes=None) -> tuple:
    """Phase 17: LDA at the NYTimes shape on ``device``, then the quality
    and parity legs at the test configurations. Returns (metrics, the row
    kernels' launches over the full-width run). ``sizes`` shrinks the
    full-width run for a CPU rehearsal."""
    from multiverso_tpu_torch.models.lda import (LDAConfig, PSGibbsLDA,
                                                 synthetic_corpus)
    from multiverso_tpu_torch.obs.logger import load_metrics
    sz = dict(vocab=LDA_VOCAB, topics=LDA_TOPICS, doc_len=LDA_DOC_LEN,
              workers=LDA_WORKERS, docs=LDA_DOCS_PER_WORKER,
              sweeps=LDA_SWEEPS)
    sz.update(sizes or {})
    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n_docs = sz["workers"] * sz["docs"]
    t0 = time.perf_counter()
    docs, _ = synthetic_corpus(sz["vocab"], sz["topics"], n_docs,
                               sz["doc_len"], seed=LDA_SEED)
    corpus_s = time.perf_counter() - t0
    metrics_path = os.path.join(scratch, "lda_metrics.jsonl")
    mvt.init(device=device, local_workers=sz["workers"],
             metrics_path=metrics_path, metrics_interval_seconds=5.0)
    try:
        zero_launches(rows)
        t0 = time.perf_counter()
        workers, tables = [], None
        for w in range(sz["workers"]):
            cfg = LDAConfig(sz["vocab"], sz["topics"], alpha=LDA_ALPHA,
                            beta=LDA_BETA, seed=LDA_SEED + w)
            lda = PSGibbsLDA(cfg, docs[w * sz["docs"]:(w + 1) * sz["docs"]],
                             pad_to=sz["doc_len"], tables=tables)
            tables = (lda.word_topic, lda.topic_counts)
            workers.append(lda)
        seed_s = time.perf_counter() - t0
        timings = [[] for _ in workers]
        moved = [0] * len(workers)

        def sweeps(n, log=True):
            def run(slot):
                with mvt.worker(slot):
                    for _ in range(n):
                        t = time.perf_counter()
                        n_moved = workers[slot].sweep()
                        if log:
                            moved[slot] += n_moved
                            timings[slot].append(dict(
                                workers[slot].last_timings, start=t,
                                end=time.perf_counter()))
            join_workers(len(workers), run)

        t0 = time.perf_counter()
        sweeps(sz["sweeps"])
        sweep_wall = time.perf_counter() - t0
        launches = launch_counts(rows)
        # after every worker's first sweep (its kernels' first loads)
        steady_from = max(ts[0]["end"] for ts in timings)
        steady_end = max(ts[-1]["end"] for ts in timings)
        t0 = time.perf_counter()
        live = lda_check_counts(workers, "LDA at full width")
        check_s = time.perf_counter() - t0
        dev_ms = lda_sweep_device_ms(workers[0]) if device == "cuda" else None
        path_rows = (lda_path_rows(mvt, rows, workers[0])
                     if device == "cuda" else None)
        # the card's busy share over one more round of sweeps, profiled;
        # the counts are checked again after it
        prof = (profile(lambda: sweeps(1, log=False))
                if device == "cuda" else None)
        busy = (prof["device_busy_ms"] / prof["wall_ms"]
                if prof and isinstance(prof["device_busy_ms"], float) else None)
        lda_check_counts(workers, "LDA after the profiled round")
        words = [len(np.unique(w.tokens[w.tokens >= 0])) for w in workers]
    finally:
        stop_runtime(mvt)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else None)
    snaps = load_metrics(metrics_path)
    if not any("SERVER_PROCESS_ADD_MSG" in s.get("monitors", {})
               for s in snaps):
        raise AssertionError("LDA: no metrics snapshot holds "
                             "SERVER_PROCESS_ADD_MSG")
    ms = lambda key: percentiles([t[key] * 1e3 for ts in timings for t in ts])
    for ts in timings:
        for t in ts:
            t["total"] = t["end"] - t["start"]
    metrics = {
        "vocab": sz["vocab"], "topics": sz["topics"],
        "workers": sz["workers"], "docs": n_docs, "doc_len": sz["doc_len"],
        "sweeps": sz["sweeps"], "live_tokens": live,
        "distinct_words_per_worker": words,
        "tokens_per_s": live * sz["sweeps"] / sweep_wall,
        "tokens_per_s_after_first_sweep": (live * (sz["sweeps"] - 1)
                                           / (steady_end - steady_from)),
        "first_sweep_ms": [ts[0]["total"] * 1e3 for ts in timings],
        "device_busy_share_profiled_round": busy,
        "peak_device_gb": peak_gb, "path_rows_bitwise": path_rows,
        "sweep_ms": ms("total"), "pull_ms": ms("pull"),
        "sweep_fn_host_ms": ms("sweep"), "push_ms": ms("push"),
        "sweep_fn_device_ms": dev_ms,
        "tokens_moved": moved,
        "sweep_wall_s": sweep_wall, "corpus_s": corpus_s,
        "seed_push_s": seed_s, "count_check_s": check_s,
        "metrics_snapshots": len(snaps)}
    print(f"LDA at {sz['vocab']} x {sz['topics']} on {card}: "
          f"{json.dumps(metrics)}", flush=True)
    metrics["card_vs_cpu"] = lda_card_vs_cpu(mvt) if device == "cuda" else None
    metrics["planted"] = lda_planted(mvt, device)
    metrics["example_purity"] = lda_example(device)
    metrics["phase_s"] = time.perf_counter() - t_phase
    return metrics, launches


# -- 18. the self-driving control plane -----------------------------------------
# Leg 1: the fleet autopilot (``mvt.autopilot``) over configuration 10's
# fleet: the three tables of phase 16 at full width, range-sharded over two
# durable shard processes on this card. Two writer threads stream zipf-hot
# Adds into shard 0's range; the loop, ticked by hand against a recorder
# sampled on a script clock, splits shard 0, then adds a read replica, then
# freezes on a divergence the replica plants in its own table on the card.
# Leg 2: the knob tuner (``KnobController``) stepping a live server in this
# process under ``wal_sync=always``.

AP_WRITERS = 2
AP_ADD_ROWS = 256                 # rows an Add, distinct, zipf by rank
AP_ZIPF_A = 1.1
AP_MIN_ACKED = 64                 # Adds on shard 0 in the window at tick 1
AP_AFTER_ADDS = 64                # Adds acknowledged on the split layout
AP_WINDOW_S = 4.0                 # the loop's window on the script clock
AP_HEDGES = 40                    # READ_HEDGES in the window before tick 2
AP_READ_GETS = 16                 # replica-preferred Gets after tick 2
AP_CORRUPT_ROW = 7                # the replica flips this row (zipf-hot)
AP_WORKERS = AP_WRITERS + 3       # + the replica reader, the final client
TUNE_CLIENTS = 4
TUNE_TICK_S = 2.0                 # sample period = the tuner's window
TUNE_VERIFY_TICKS = 2
TUNE_MAX_TICKS = 6                # a pass's ticks up to its verdict


def zipf_rows(rng, n: int, span: int, a: float = AP_ZIPF_A) -> np.ndarray:
    """``n`` distinct rows of ``[0, span)`` drawn zipf(a) by rank without
    replacement: draws past the span are dropped, a repeat keeps the place
    of its first draw."""
    picked = np.empty(0, np.int64)
    while picked.size < n:
        draw = rng.zipf(a, 4 * n) - 1
        draw = np.concatenate([picked, draw[draw < span]])
        _, first = np.unique(draw, return_index=True)
        picked = draw[np.sort(first)]
    return picked[:n].astype(np.int32)


def time_calls(obj, names, sink: dict) -> None:
    """Wrap ``obj``'s methods ``names``: each call's ms lands in ``sink``
    under the method's name (the last call wins)."""
    for name in names:
        fn = getattr(obj, name)

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                sink[_name] = (time.perf_counter() - t0) * 1e3
        setattr(obj, name, timed)


def wait_until(cond, what: str, errors: list, timeout: float = CLIENT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if errors:
            raise errors[0]
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} after {timeout} s")
        time.sleep(0.01)


def autopilot_leg(mvt, device: str, card: str, scratch: str, sz: dict,
                  seed: int) -> tuple:
    """Leg 1 (the section's comment). Returns (metrics, the group's
    row-kernel launches by process role)."""
    from multiverso_tpu_torch.config import FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard, count
    from multiverso_tpu_torch.obs.timeseries import TimeSeriesRecorder
    from multiverso_tpu_torch.runtime.remote import (fetch_stats,
                                                     fetch_watermark)
    R, C, B = sz["num_row"], sz["num_col"], sz["ap_rows"]
    span = R // SHARDS                    # shard 0's range
    flight = os.path.join(scratch, "autopilot_flight.jsonl")
    flags = dict(autopilot_hysteresis_ticks=1,
                 autopilot_window_seconds=AP_WINDOW_S,
                 autopilot_hedge_rate=1.0,
                 autopilot_scaledown_qps=0.0,   # keep the new replica
                 reshard_cold_qps=0.0,          # no merges in this leg
                 reshard_min_qps=1.0, reshard_hot_ratio=2.0,
                 read_staleness_records=1 << 30,
                 flight_recorder_path=flight)
    for name, value in flags.items():
        FLAGS.set(name, value)
    base = {n: Dashboard.counter_value(n) for n in (
        "AUTOPILOT_ACTIONS", "AUTOPILOT_FROZEN_SKIPS", "AUTOPILOT_FREEZES",
        "AUTOPILOT_ACKS", "AUDIT_DIVERGENCE", "AUDIT_RUNS",
        "READS_VIA_REPLICA")}
    out, ticks = {}, []
    t0 = time.perf_counter()
    group = mvt.serve_sharded(
        shard_specs(R, C), shards=SHARDS, durable=True, device=device,
        base_dir=os.path.join(scratch, "ap"),
        flags=dict(SHARD_GROUP_FLAGS, remote_workers=AP_WORKERS))
    out["group_start_s"] = time.perf_counter() - t0
    clients, stop, threads = [], threading.Event(), []
    try:
        clients = [group.connect() for _ in range(AP_WRITERS)]
        mirror = np.zeros((R, C), np.float32)
        # one Add across both shards before the window opens, so every
        # primary has applied an Add
        rng = np.random.default_rng([seed, 0])
        warm = np.sort(rng.choice(R, B, replace=False)).astype(np.int32)
        wvals = rng.integers(0, 5, (B, C)).astype(np.float32)
        clients[0].table(0).add(wvals, row_ids=warm)
        mirror[warm] += wvals

        recorder = TimeSeriesRecorder(interval=3600.0, samples=16)
        pilot = mvt.autopilot(group, interval=0, recorder=recorder)
        ms = {}
        time_calls(pilot.sensors, ("read",), ms)
        time_calls(pilot.policy, ("decide",), ms)
        coord = pilot.actuators.coordinator
        plans, split = [], coord.split

        def split_and_keep(shard, *args, **kwargs):
            plans.append(split(shard, *args, **kwargs))
            return plans[-1]
        coord.split = split_and_keep

        def tick(now: float) -> dict:
            ms.clear()
            t = time.perf_counter()
            record = pilot.tick_now(now=now)
            ticks.append({"now": now, "action": record["action"],
                          "tick_ms": (time.perf_counter() - t) * 1e3,
                          "sense_ms": ms.get("read"),
                          "decide_ms": ms.get("decide")})
            return record

        lock, errors, acked, lat = threading.Lock(), [], [0], []

        def writer(w: int) -> None:
            mat = clients[w].table(0)
            wrng = np.random.default_rng([seed, w + 1])
            try:
                while not stop.is_set():
                    ids = zipf_rows(wrng, B, span)
                    vals = wrng.integers(0, 5, (B, C)).astype(np.float32)
                    t = time.perf_counter()
                    mat.add(vals, row_ids=ids)
                    dt = time.perf_counter() - t
                    with lock:
                        mirror[ids] += vals
                        acked[0] += 1
                        lat.append((t, dt))
            except BaseException as err:  # reported below, never passed over
                errors.append(err)

        recorder.sample_now(t=100.0)
        threads = [threading.Thread(target=writer, args=(w,), daemon=True)
                   for w in range(AP_WRITERS)]
        for t in threads:
            t.start()
        # tick 1 waits for acknowledged Adds, not for a fixed time
        wait_until(lambda: acked[0] >= AP_MIN_ACKED, "too few Adds", errors)
        recorder.sample_now(t=100.0 + AP_WINDOW_S)
        in_window = [recorder.window_histogram(f"ROUTER_SHARD{k}_SECONDS",
                                               AP_WINDOW_S)
                     for k in range(SHARDS)]
        out["window_adds_by_shard"] = [0 if h is None else int(h.count)
                                       for h in in_window]
        if out["window_adds_by_shard"][0] < AP_MIN_ACKED:
            raise AssertionError(f"tick 1: {out['window_adds_by_shard']} "
                                 f"Adds in the window, want >= "
                                 f"{AP_MIN_ACKED} on shard 0")
        t_split = time.perf_counter()
        rec1 = tick(100.0 + AP_WINDOW_S)
        t_split_end = time.perf_counter()
        if rec1["action"] != "split" or rec1["decision"]["shard"] != 0 \
                or not rec1["outcome"]["ok"]:
            raise AssertionError(f"tick 1: {json.dumps(rec1)[:2000]}")
        lv = group.layout.manifest["layout_version"]
        if group.num_shards != 3 or lv != 2:
            raise AssertionError(f"tick 1: {group.num_shards} shards, "
                                 f"layout v{lv}; want 3 and v2")
        plan = plans[0]
        joiners = []
        for j in plan.joiners:
            path = os.path.join(group.base_dir,
                                f"join-v{plan.new_version}.{j['shard']}.status")
            with open(path) as f:
                st = json.load(f)
            joiners.append(st)
        during = acked[0]
        wait_until(lambda: acked[0] >= during + AP_AFTER_ADDS,
                   "too few Adds after the split", errors)
        stop.set()
        for t in threads:
            t.join(timeout=CLIENT_S)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise TimeoutError("leg 1: a writer did not stop")
        out["split"] = {
            "rate": rec1["decision"]["params"]["rate"],
            "seconds": rec1["outcome"]["seconds"],
            "start_to_cutover_s": plan.timings["cutover_s"],
            "start_to_serving_s": plan.timings["serving_s"],
            "transfer_mb": sum(j["transfer_bytes"] for j in joiners) / 1e6,
            "transfer_s": max(j["transfer_s"] for j in joiners),
            "records_replayed": sum(j["records_applied"] for j in joiners),
            "adds_during": during - AP_MIN_ACKED}

        def add_ms(sel):
            xs = [dt * 1e3 for t, dt in lat if sel(t)]
            return dict(percentiles(xs), n=len(xs)) if xs else None
        out["add_ms"] = {
            "before": add_ms(lambda t: t < t_split),
            "during": add_ms(lambda t: t_split <= t < t_split_end),
            "after": add_ms(lambda t: t >= t_split_end)}
        out["adds_acked"] = acked[0] + 1

        # tick 2: read-tier pressure; the replica it spawns is armed to
        # flip a row of its table once it has synced
        recorder.sample_now(t=108.0)
        count("READ_HEDGES", AP_HEDGES)
        recorder.sample_now(t=112.0)
        os.environ["MV_AUDIT_CORRUPT"] = f"0:{AP_CORRUPT_ROW}:0"
        try:
            t = time.perf_counter()
            rec2 = tick(112.0)
        finally:
            os.environ.pop("MV_AUDIT_CORRUPT", None)
        if rec2["action"] != "add_replica" or not rec2["outcome"]["ok"]:
            raise AssertionError(f"tick 2: {json.dumps(rec2)[:2000]}")
        shard = rec2["decision"]["shard"]
        replica = rec2["outcome"]["detail"]["endpoint"]
        if group.replica_endpoints[shard] != [replica]:
            raise AssertionError(f"tick 2: shard {shard} replicas "
                                 f"{group.replica_endpoints[shard]}")
        primary_wm = fetch_watermark(group.endpoints[shard])["watermark"]
        wait_until(lambda: fetch_watermark(replica)["watermark"]
                   >= primary_wm, "the replica never caught up", [])
        out["replica"] = {"shard": shard, "primary_watermark": primary_wm,
                          "start_to_serving_s": rec2["outcome"]["seconds"],
                          "start_to_caught_up_s": time.perf_counter() - t}
        reader = group.connect(read_preference="replica")
        clients.append(reader)
        lo = int(group.layout.manifest["tables"][0]["partitioner"]
                 ["bounds"][shard])
        ids = np.arange(lo + AP_CORRUPT_ROW + 1,
                        lo + AP_CORRUPT_ROW + 1 + B, dtype=np.int32)
        for _ in range(AP_READ_GETS):
            got = reader.table(0).get(row_ids=ids)
            if not np.array_equal(got, mirror[ids]):
                raise AssertionError("leg 1: a replica Get != the mirror")
        out["replica"]["reads_via_replica"] = (
            Dashboard.counter_value("READS_VIA_REPLICA")
            - base["READS_VIA_REPLICA"])

        # tick 3: an audit finds the planted row; the loop freezes
        auditor = mvt.audit(group, interval=0)

        def caught() -> bool:
            auditor.check()
            return (Dashboard.counter_value("AUDIT_DIVERGENCE")
                    > base["AUDIT_DIVERGENCE"])
        t = time.perf_counter()
        try:
            wait_until(caught, "the audit never caught the planted row", [],
                       timeout=60)
        except TimeoutError as err:
            raise TimeoutError(f"{err}; the last audit report: "
                               f"{json.dumps(auditor.last_report)[:2000]}"
                               ) from None
        out["audit_s"] = time.perf_counter() - t
        # the replica's fresh state transfers since it joined (each loads
        # the primary's bytes; the drill re-plants its flip after each)
        rstats = fetch_stats(replica)
        out["replica"]["resyncs"] = {n: rstats.counter(n) for n in (
            "STANDBY_FALSE_LEASE_EXPIRY", "REPLICA_GAP_RESYNCS",
            "FAULT_INJECTED_STATE_CORRUPT")}
        frozen = [tick(120.0)["action"], tick(121.0)["action"]]
        pilot.ack("chip_smoke")
        after_ack = tick(122.0)["action"]
        if frozen != ["frozen", "frozen"] or after_ack == "frozen" \
                or pilot.interlock.frozen:
            raise AssertionError(f"tick 3: {frozen}, then {after_ack}")
        counts = {n: Dashboard.counter_value(n) - base[n] for n in base}
        if counts["AUTOPILOT_ACTIONS"] != 2 or \
                counts["AUTOPILOT_FROZEN_SKIPS"] != 2:
            raise AssertionError(f"leg 1 counters: {counts}")
        out["counters"] = counts
        out["after_ack"] = after_ack

        t = time.perf_counter()
        final = group.connect()
        clients.append(final)
        if not np.array_equal(final.table(0).get(), mirror):
            raise AssertionError("leg 1: the table != the writers' mirror "
                                 "(an acknowledged Add was lost)")
        out["final_get_s"] = time.perf_counter() - t
        with open(flight) as f:
            dumps = [json.loads(x) for x in f if '"kind": "event"' in x]
        out["flight_dumps"] = [e["reason"] for e in dumps
                               if e["reason"].startswith("autopilot_")]
        pilot.stop()
    except BaseException:
        stop.set()
        print(group_logs(group), flush=True)
        raise
    finally:
        for c in clients:
            c.close()
        group.stop()
        for name in flags:
            FLAGS.reset(name)
    out["ticks"] = ticks
    return out, group.kernel_launches()


def check_autopilot_launches(launches: dict, on_card: bool) -> dict:
    """Leg 1's kernel readout: the scatter in every primary and joiner,
    the gather in the replica (on the card; a CPU group runs the plain
    versions, which launch nothing). Returns the counts by role."""
    joiners = [r for r in launches if r.startswith("join-")]
    replicas = [r for r in launches if r.startswith("replica")]
    if len(joiners) != 2 or len(replicas) != 1:
        raise AssertionError(f"leg 1: roles {sorted(launches)}")
    for role in ["shard0", "shard1"] + joiners if on_card else ():
        if launches[role]["scatter_add_rows"] <= 0:
            raise AssertionError(f"scatter_add_rows: no launch in {role}")
    if on_card and launches[replicas[0]]["gather_rows"] <= 0:
        raise AssertionError(f"gather_rows: no launch in {replicas[0]}")
    return {role: {k: c[k] for k in ("scatter_add_rows", "gather_rows")}
            for role, c in launches.items()}


class ThreadWaits:
    """A profiler view of one thread: the wait seconds the sampling
    profiler charged to the threads named ``name`` (the dispatcher's,
    where ``apply_batch_msgs`` acts)."""

    def __init__(self, profiler, name: str) -> None:
        self.profiler, self.name = profiler, name

    def wait_seconds(self) -> dict:
        info = self.profiler.report(top_stacks=0)["threads"].get(self.name)
        return {site: s for site, s in (info or {}).get("waits", {}).items()
                if not site.startswith("blocked:")}


def tune_pass(ctl, recorder, clock: list) -> list:
    """Tick ``ctl`` every ``TUNE_TICK_S`` seconds (the recorder sampled on
    the script clock just before) up to its first verdict."""
    records = []
    for _ in range(TUNE_MAX_TICKS):
        time.sleep(TUNE_TICK_S)
        clock[0] += TUNE_TICK_S
        recorder.sample_now(t=clock[0])
        records.append(ctl.tick_now(now=clock[0]))
        if records[-1]["action"] in ("commit", "revert"):
            break
    return records


def tuner_leg(mvt, rows, device: str, card: str, scratch: str, sz: dict,
              seed: int) -> tuple:
    """Leg 2 (the section's comment): configuration 1's matrix served
    from this process with ``wal_sync=always`` and ``apply_batch_msgs``
    0, 4 client threads here (so the objective's latency histogram is
    this process's) sending integer-valued 1024-row Adds. Two tuner
    passes: the first reads the dispatcher thread's waits, the second
    the whole process's. Returns (metrics, row-kernel launches)."""
    from multiverso_tpu_torch.config import FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.obs.profiler import PROFILER
    from multiverso_tpu_torch.obs.timeseries import TimeSeriesRecorder
    from multiverso_tpu_torch.tune import KnobController, TuneSensors
    from multiverso_tpu_torch.tune.rules import (actionable_dominant,
                                                 default_rules)
    R, C, B = sz["num_row"], sz["num_col"], sz["batch"]
    flight = os.path.join(scratch, "tune_flight.jsonl")
    mvt.init(device=device, remote_workers=TUNE_CLIENTS, heartbeat_seconds=0,
             wal_dir=os.path.join(scratch, "tune_wal"), wal_sync="always",
             apply_batch_msgs=0, profile_continuous=True,
             flight_recorder_path=flight)
    out = {}
    clients, threads, stop, errors = [], [], threading.Event(), []
    try:
        table = mvt.create_table("matrix", num_row=R, num_col=C)
        ep = mvt.serve("127.0.0.1:0")
        zero_launches(rows)
        base = {n: Dashboard.counter_value(n) for n in (
            "TUNE_STEPS", "TUNE_COMMITS", "TUNE_REVERTS", "TUNE_TICKS")}
        mirror = np.zeros((R, C), np.float32)
        lock, sent = threading.Lock(), [0]
        clients = [mvt.remote_connect(ep) for _ in range(TUNE_CLIENTS)]

        def client(i: int) -> None:
            t = clients[i].table(table.table_id)
            rng = np.random.default_rng([seed, i])
            try:
                while not stop.is_set():
                    ids = rng.integers(0, R, B).astype(np.int32)
                    vals = int_rows(rng, (B, C))
                    t.add(vals, row_ids=ids)
                    with lock:
                        np.add.at(mirror, ids, vals)
                        sent[0] += 1
            except BaseException as err:  # reported below
                errors.append(err)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(TUNE_CLIENTS)]
        for t in threads:
            t.start()
        wait_until(lambda: sent[0] >= 4 * TUNE_CLIENTS, "no Adds", errors)
        recorder = TimeSeriesRecorder(interval=3600.0, samples=64)
        clock = [0.0]
        recorder.sample_now(t=clock[0])
        rules = default_rules()
        for view in ("dispatcher", "process"):
            profiler = (PROFILER if view == "process"
                        else ThreadWaits(PROFILER, "mv-server"))
            sensors = TuneSensors(recorder=recorder, profiler=profiler,
                                  window=TUNE_TICK_S)
            senses = []
            read = sensors.read

            def keep(now=None, _read=read, _senses=senses):
                _senses.append(_read(now=now))
                return _senses[-1]
            sensors.read(now=clock[0])          # the window starts here
            sensors.read = keep
            ctl = KnobController(sensors=sensors, rules=rules, interval=0,
                                 hysteresis=1,
                                 verify_ticks=TUNE_VERIFY_TICKS,
                                 cooldown=60.0, regress_pct=5.0)
            records = tune_pass(ctl, recorder, clock)
            steps = [r for r in records if r["action"] == "step"]
            if len(steps) != 1 or records[-1]["action"] not in (
                    "commit", "revert"):
                raise AssertionError(f"tuner ({view}): "
                                     f"{[r['action'] for r in records]}")
            step = steps[0]["step"]
            sense = senses[records.index(steps[0])]
            want_rule = next(r.name for r in rules if r.predicate(sense))
            if step["rule"] != want_rule:
                raise AssertionError(f"tuner ({view}): stepped "
                                     f"{step['rule']}, sensed {want_rule}")
            if view == "dispatcher" and (step["flag"], step["old"],
                                         step["new"]) != (
                    "apply_batch_msgs", 0, 8):
                raise AssertionError(f"tuner (dispatcher): {step}")
            verdict = records[-1]["verdict"]
            regressed = (verdict["baseline"] > 0
                         and verdict["objective"] < verdict["regress_bar"])
            if records[-1]["action"] != ("revert" if regressed else "commit"):
                raise AssertionError(f"tuner ({view}): {records[-1]}")
            live = FLAGS.get(step["flag"])
            value = step["old"]
            with open(flight) as f:
                for line in f:
                    e = json.loads(line)
                    if e.get("kind") == "event" and \
                            e["reason"].startswith("tune_") and \
                            e.get("flag") == step["flag"]:
                        value = e["old"] if e["reason"] == "tune_revert" \
                            else e["new"]
            if value != live or live != (step["old"] if regressed
                                         else step["new"]):
                raise AssertionError(f"tuner ({view}): flight records give "
                                     f"{value}, the flag is {live}")
            out[view] = {
                "rule": step["rule"], "flag": step["flag"],
                "old": step["old"], "new": step["new"],
                "verdict": records[-1]["action"], "value_at_end": live,
                "dominant": actionable_dominant(sense),
                "wait_s": sense.as_dict()["wait"],
                "objective_before": verdict["baseline"],
                "objective_after": verdict["objective"],
                "regress_bar": verdict["regress_bar"],
                "p99_ms_before": sense.p99 * 1e3,
                "p99_ms_after": senses[-1].p99 * 1e3,
                "adds_per_s_before": sense.throughput,
                "adds_per_s_after": senses[-1].throughput,
                "ticks": [r["action"] for r in records]}
        stop.set()
        for t in threads:
            t.join(timeout=CLIENT_S)
        if errors:
            raise errors[0]
        out["counters"] = {n: Dashboard.counter_value(n) - base[n]
                           for n in base}
        out["knobs_at_end"] = {k: FLAGS.get(k) for k in (
            "apply_batch_msgs", "wire_coalesce_frames",
            "wire_coalesce_bytes")}
        out["adds"] = sent[0]
        launches = launch_counts(rows)
        if device == "cuda" and launches["scatter_add_rows"] <= 0:
            raise AssertionError("scatter_add_rows: no launch in leg 2")
        if not np.array_equal(np.asarray(table.get(), np.float32), mirror):
            raise AssertionError("leg 2: the table != the clients' mirror")
    finally:
        stop.set()
        for c in clients:
            c.close()
        stop_runtime(mvt)
    return out, launches


def control_phase(mvt, rows, device: str, card: str, scratch: str,
                  sizes=None) -> tuple:
    """Phase 18: the fleet autopilot over configuration 10's fleet (leg
    1) and the knob tuner on a live server (leg 2). Returns (metrics,
    launches by leg and process role). ``sizes`` shrinks the legs for a
    CPU rehearsal."""
    sz = dict(num_row=ROWS, num_col=COLS, batch=BATCH, ap_rows=AP_ADD_ROWS)
    sz.update(sizes or {})
    t_phase = time.perf_counter()
    metrics, launches = {}, {}
    t0 = time.perf_counter()
    metrics["1_autopilot"], group_launches = autopilot_leg(
        mvt, device, card, scratch, sz, 18)
    launches["1_autopilot"] = check_autopilot_launches(
        group_launches, device == "cuda")
    metrics["1_autopilot"]["leg_s"] = time.perf_counter() - t0
    print(f"autopilot (leg 1) on {card}: {json.dumps(metrics['1_autopilot'])}"
          f"; row-kernel launches by role: "
          f"{json.dumps(launches['1_autopilot'])}", flush=True)
    t0 = time.perf_counter()
    metrics["2_tuner"], launches["2_tuner"] = tuner_leg(
        mvt, rows, device, card, scratch, sz, 19)
    metrics["2_tuner"]["leg_s"] = time.perf_counter() - t0
    print(f"knob tuner (leg 2) on {card}: {json.dumps(metrics['2_tuner'])}",
          flush=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    return metrics, launches


# -- phase 19: the multi-process lockstep PS -----------------------------------
# Two ranks of one torch.distributed world (gloo) on the one card, each a
# process of this script (``--multihost-rank``) with its own CUDA context.
MH_RANKS = 2
MH_LOCAL_WORKERS = 2              # 2 a rank: configuration 1's 4 workers
MH_ASYNC_ROUNDS = 128             # leg 1: async 1024-row Add+Get rounds
MH_BSP_ROUNDS = 32                # leg 1: BSP rounds after the restore
MH_CTRL_OPS = 50                  # 4-row sync Adds a rank: the ctrlperf twin
MH_W2V_BLOCKS = 8                 # leg 2: 8192-token blocks, ranks in turn
MH_AGG_FLOATS = 464_154           # leg 3: configuration 7's table (1.86 MB)
MH_SEED = 19
MH_S = 300                        # a rank's limit


def mh_round(seed: int, wid: int, k: int, num_row: int, num_col: int,
             batch: int):
    """Worker ``wid``'s round ``k``: Add ids (duplicates included), integer
    Add values (every float32 sum exact, in any order), Get ids."""
    rng = np.random.default_rng([seed, wid, k, 3])
    return (rng.integers(0, num_row, batch).astype(np.int32),
            int_rows(rng, (batch, num_col)),
            rng.integers(0, num_row, batch).astype(np.int32))


def mh_mirror(sz: dict) -> tuple:
    """Leg 1's table as numpy sums it: every worker's async Adds, then the
    BSP rounds one at a time. Returns (table, Get digests): the digest of
    BSP round ``k``'s Get rows of worker ``wid`` at ``[wid][k]``, read
    after round ``k`` of every worker's Adds, as BSP promises."""
    mirror = np.zeros((sz["num_row"], sz["num_col"]), np.float32)
    workers = MH_RANKS * MH_LOCAL_WORKERS
    args = (sz["num_row"], sz["num_col"], sz["batch"])
    for wid in range(workers):
        for k in range(sz["async_rounds"]):
            ids, vals, _ = mh_round(MH_SEED, wid, k, *args)
            np.add.at(mirror, ids, vals)
    gets = [[] for _ in range(workers)]
    for k in range(sz["async_rounds"], sz["async_rounds"] + sz["bsp_rounds"]):
        rounds = [mh_round(MH_SEED, wid, k, *args) for wid in range(workers)]
        for ids, vals, _ in rounds:
            np.add.at(mirror, ids, vals)
        for wid, (_, _, gids) in enumerate(rounds):
            gets[wid].append(mh_digest(mirror[gids]))
    return mirror, gets


def mh_agg_value(wid: int, n: int) -> np.ndarray:
    return np.random.default_rng([MH_SEED, wid, 7]).standard_normal(
        n, dtype=np.float32)


def mh_w2v_block(sz: dict, i: int):
    """Leg 2's block ``i``, its host seed and its device draws: the same
    in the world and in the one-process run it is held against."""
    w2v = mh_w2v_config(sz)
    tokens = zipf_tokens(np.random.default_rng([MH_SEED, i, 5]),
                         w2v["block_tokens"], w2v["vocab_size"])

    def hook(step, t, tg, pool):
        rng = np.random.default_rng([MH_SEED, i, step, 6])
        return {"win": rng.integers(1, w2v["window"] + 1, t),
                "neg": rng.integers(0, pool, (tg, w2v["negatives"]))}

    return tokens, np.random.default_rng([MH_SEED, i]), hook


def mh_w2v_config(sz: dict) -> dict:
    return dict(W2V, vocab_size=sz["vocab"], dim=sz["dim"])


def mh_w2v_run(mvt, sz: dict, turn, barrier) -> tuple:
    """Train leg 2's blocks: block i where ``turn(i)``, each from its own
    host seed and draws, ``barrier()`` after each. Returns (trainer,
    losses, seconds)."""
    from multiverso_tpu_torch.models.word2vec import PSTrainer, Word2VecConfig
    from multiverso_tpu_torch.models.vocab import Dictionary
    w2v = mh_w2v_config(sz)
    d = Dictionary()
    d.words = [f"w{i}" for i in range(w2v["vocab_size"])]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = w2v_counts(w2v["vocab_size"])
    trainer = PSTrainer(Word2VecConfig(**w2v), d)  # collective creation
    if not trainer._can_transact():
        raise AssertionError("word2vec: the named block transaction is off")
    barrier()
    losses = {}
    t0 = time.perf_counter()
    for i in range(sz["blocks"]):
        if turn(i):
            tokens, trainer.rng, trainer.draw_hook = mh_w2v_block(sz, i)
            with mvt.worker(0):
                losses[i] = trainer.train_block(tokens)
        barrier()
    return trainer, losses, time.perf_counter() - t0


def mh_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def multihost_rank_main(argv) -> int:
    """``chip_smoke.py --multihost-rank RANK COORD_PORT OUTDIR``: one rank
    of phase 19's world (its spec in ``OUTDIR/spec.json``). Writes
    ``OUTDIR/rank<R>.json``; rank 0 also leaves the final tables there."""
    from multiverso_tpu_torch import checkpoint
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.ops import kernels, rows
    rank, coord, outdir = int(argv[0]), argv[1], argv[2]
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    sz, device, world = spec["sizes"], spec["device"], spec["world"]
    if device == "cuda":
        kernels.load("rows")  # built by the parent: a cache hit
    else:
        torch.set_num_threads(1)
    out = {"rank": rank}
    t0 = time.perf_counter()
    mvt.init_distributed(f"127.0.0.1:{coord}", world, rank)
    flags = dict(device=device, local_workers=MH_LOCAL_WORKERS,
                 multihost_endpoint=f"127.0.0.1:{spec['ctl'][0]}")
    mvt.init(**flags)
    zoo = mvt.Zoo.instance()
    out["bringup_s"] = time.perf_counter() - t0
    out["device"] = str(zoo.device)
    num_row, num_col, batch = sz["num_row"], sz["num_col"], sz["batch"]

    def drive(mat, rounds: int, base: int, sync: bool) -> dict:
        """Both local workers' rounds; per-op latencies and the window."""
        lat = {0: ([], []), 1: ([], [])}
        digests = {}

        def work(slot):
            wid = rank * MH_LOCAL_WORKERS + slot
            adds, gets = lat[slot]
            seen = digests.setdefault(wid, [])
            with mvt.worker(slot):
                for k in range(rounds):
                    ids, vals, gids = mh_round(MH_SEED, wid, base + k,
                                               num_row, num_col, batch)
                    a = time.perf_counter()
                    mat.add(vals, row_ids=ids)
                    b = time.perf_counter()
                    got = mat.get(gids)
                    adds.append(b - a)
                    gets.append(time.perf_counter() - b)
                    if got.shape != (batch, num_col) or not np.isfinite(got).all():
                        raise AssertionError(f"bad Get reply {got.shape}")
                    if sync:  # held to the mirror's round by the parent
                        seen.append(mh_digest(got))
                if sync:
                    mat.finish_train()

        start = time.time()
        join_workers(MH_LOCAL_WORKERS, work, timeout=MH_S)
        end = time.time()
        adds = [x for s in lat for x in lat[s][0]]
        gets = [x for s in lat for x in lat[s][1]]
        return {"start": start, "end": end, "adds": len(adds),
                "get_digests": {str(w): d for w, d in digests.items()},
                "add_ms": [x * 1e3 for x in adds],
                "get_ms": [x * 1e3 for x in gets]}

    # leg 1, async: configuration 1's matrix split over the ranks
    mat = mvt.create_table("matrix", num_row, num_col, np.float32)
    srv = mat._server_table
    out["rows_held"] = [srv.row_lo, srv.row_hi]
    out["shard_bytes"] = srv.data.numel() * srv.data.element_size()
    mvt.process_barrier()
    zero_launches(rows)
    zoo.multihost.exchange_log.clear()
    out["async"] = drive(mat, sz["async_rounds"], 0, sync=False)
    exch = list(zoo.multihost.exchange_log)
    out["get_exchange_ms"] = [t * 1e3 for t, _ in exch]
    out["get_exchange_bytes"] = float(np.mean([b for _, b in exch]))
    mvt.process_barrier()
    ones, ids4 = np.ones((4, num_col), np.float32), np.arange(4, dtype=np.int32)
    ctrl = []
    with mvt.worker(0):
        mat.add(ones, row_ids=ids4)  # warm
        for _ in range(MH_CTRL_OPS):
            a = time.perf_counter()
            mat.add(ones, row_ids=ids4)
            ctrl.append((time.perf_counter() - a) * 1e3)
        mat.add(-(MH_CTRL_OPS + 1) * ones, row_ids=ids4)  # back out
    out["ctrl_op_ms"] = float(np.median(ctrl))
    mvt.process_barrier()

    # leg 2: word2vec at configuration 2's width, ranks in turn
    from multiverso_tpu_torch.ops import sgns
    sgns.sgns_chunk.launches = 0
    trainer, losses, secs = mh_w2v_run(
        mvt, sz, lambda i: i % world == rank, mvt.process_barrier)
    with mvt.worker(0):
        w_in = trainer.input_table.get()
        w_out = trainer.output_table.get()
    out["w2v"] = {"losses": {str(i): v for i, v in losses.items()},
                  "seconds": secs, "in_digest": mh_digest(w_in),
                  "out_digest": mh_digest(w_out),
                  "words": sz["blocks"] * W2V["block_tokens"],
                  "sgns_launches": sgns.sgns_chunk.launches}
    if rank == 0:
        np.save(os.path.join(outdir, "w2v_in.npy"), w_in)
        np.save(os.path.join(outdir, "w2v_out.npy"), w_out)
    del w_in, w_out, trainer
    mvt.process_barrier()

    # leg 3: snapshot leg 1's table on the leader; every rank reads its rows
    with mvt.worker(0):
        before = mat.get()
    out["pre_snapshot_digest"] = mh_digest(before)
    del before
    path = os.path.join(outdir, "leg1.mvckpt")
    if rank == 0:
        a = time.perf_counter()
        checkpoint.store_table(mat, path)
        out["snapshot_s"] = time.perf_counter() - a
    mvt.process_barrier()
    out["launches_async"] = launch_counts(rows)
    mvt.shutdown()

    # a BSP world restores it, runs its rounds, and aggregates
    mvt.init(**dict(flags, sync=True,
                    multihost_endpoint=f"127.0.0.1:{spec['ctl'][1]}"))
    zoo = mvt.Zoo.instance()
    mat = mvt.create_table("matrix", num_row, num_col, np.float32)
    if rank == 0:
        a = time.perf_counter()
        checkpoint.load_table(mat, path)
        out["restore_s"] = time.perf_counter() - a
    mvt.process_barrier()
    with zoo.admin():
        out["restored_digest"] = mh_digest(mat.get())
    out["bsp"] = drive(mat, sz["bsp_rounds"], sz["async_rounds"], sync=True)
    mvt.process_barrier()
    with zoo.admin():
        final = mat.get()
    out["final_digest"] = mh_digest(final)
    if rank == 0:
        np.save(os.path.join(outdir, "leg1_final.npy"), final)
    del final
    agg = {}

    def aggregate(slot):
        wid = rank * MH_LOCAL_WORKERS + slot
        value = torch.from_numpy(mh_agg_value(wid, sz["agg"])).to(zoo.device)
        with mvt.worker(slot):
            a = time.perf_counter()
            total = mvt.aggregate(value)
            agg[slot] = (time.perf_counter() - a, total)

    join_workers(MH_LOCAL_WORKERS, aggregate, timeout=MH_S)
    out["aggregate_ms"] = agg[0][0] * 1e3
    out["aggregate_digest"] = mh_digest(agg[0][1].cpu().numpy())
    out["aggregate_on"] = str(agg[0][1].device)
    if not all(torch.equal(agg[0][1], agg[s][1]) for s in agg):
        raise AssertionError("aggregate: the local workers got different sums")
    out["launches"] = launch_counts(rows)
    mvt.shutdown()
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"MULTIHOST_RANK_OK rank={rank}", flush=True)
    return 0


def multihost_phase(mvt, device: str, scratch: str,
                    sizes=None) -> tuple:
    """Phase 19: a 2-rank lockstep world on ``device`` (both ranks on the
    one card), leg 1 (configuration 1, async then BSP around leg 3's
    snapshot and restore), leg 2 (word2vec at configuration 2's width,
    ranks in turn) and leg 3 (the snapshot and restore, an aggregate).
    Returns (metrics, row-kernel launches by rank). ``sizes`` shrinks it
    for a CPU rehearsal."""
    sz = dict(num_row=ROWS, num_col=COLS, batch=BATCH,
              async_rounds=MH_ASYNC_ROUNDS, bsp_rounds=MH_BSP_ROUNDS,
              vocab=W2V["vocab_size"], dim=W2V["dim"], blocks=MH_W2V_BLOCKS,
              agg=MH_AGG_FLOATS)
    sz.update(sizes or {})
    t_phase = time.perf_counter()
    outdir = os.path.join(scratch, "multihost")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"sizes": sz, "device": device, "world": MH_RANKS,
                   "ctl": [free_port(), free_port()]}, f)
    coord = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(outdir, f"rank{r}.log"), "w")
            for r in range(MH_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-rank",
         str(r), str(coord), outdir], stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=here) for r in range(MH_RANKS)]
    try:
        # the numpy mirror of leg 1 while the ranks run
        mirror, bsp_gets = mh_mirror(sz)
        codes = [p.wait(timeout=MH_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        if code != 0:
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                tail = "".join(f.readlines()[-40:])
            raise AssertionError(f"multihost rank {r} exited {code}:\n{tail}")
    world_s = time.perf_counter() - t_phase
    res = []
    for r in range(MH_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    m = {"world_s": world_s, "devices": [x["device"] for x in res],
         "bringup_s": [x["bringup_s"] for x in res],
         "rows_held": [x["rows_held"] for x in res],
         "shard_mb": [x["shard_bytes"] / 1e6 for x in res]}

    # leg 1: every view of the table is the mirror, bit for bit
    final = np.load(os.path.join(outdir, "leg1_final.npy"))
    if not np.array_equal(final, mirror):
        gap = float(np.abs(final - mirror).max())
        raise AssertionError(f"leg 1: the final table is off the mirror by "
                             f"{gap}")
    if len({x["final_digest"] for x in res} | {mh_digest(mirror)}) != 1:
        raise AssertionError("leg 1: the ranks' views of the final table "
                             "differ")
    del final, mirror
    # the BSP rounds' Gets, each through the exchange: round k's rows are
    # the mirror's after round k of every worker's Adds, bit for bit
    for x in res:
        for wid, seen in x["bsp"]["get_digests"].items():
            want = bsp_gets[int(wid)]
            bad = [k for k, (a, b) in enumerate(zip(seen, want)) if a != b]
            if bad or len(seen) != len(want):
                raise AssertionError(
                    f"leg 1: worker {wid}'s BSP Gets are off the mirror in "
                    f"rounds {bad} ({len(seen)} of {len(want)} replies)")
    m["1_bsp_gets_checked"] = sum(len(d) for x in res
                                  for d in x["bsp"]["get_digests"].values())
    for leg in ("async", "bsp"):
        start = min(x[leg]["start"] for x in res)
        end = max(x[leg]["end"] for x in res)
        adds = sum(x[leg]["adds"] for x in res)
        m[f"1_{leg}"] = {
            "adds": adds, "adds_per_s": adds / (end - start),
            "add_ms": percentiles([v for x in res for v in x[leg]["add_ms"]]),
            "get_ms": percentiles([v for x in res for v in x[leg]["get_ms"]])}
    m["1_async"]["get_exchange_ms"] = percentiles(
        [v for x in res for v in x["get_exchange_ms"]])
    m["1_async"]["get_exchange_kb"] = [x["get_exchange_bytes"] / 1e3
                                       for x in res]
    m["1_ctrl_op_ms"] = [x["ctrl_op_ms"] for x in res]

    # leg 2: the ranks' replays agree; the loss falls; the one-process port
    # run fed the same blocks and draws ends within W2V_RTOL/ATOL
    if (len({x["w2v"]["in_digest"] for x in res}) != 1
            or len({x["w2v"]["out_digest"] for x in res}) != 1):
        raise AssertionError("leg 2: the ranks' views of the word2vec tables "
                             "differ")
    losses = {}
    for x in res:
        losses.update({int(i): v for i, v in x["w2v"]["losses"].items()})
    losses = [losses[i] for i in range(sz["blocks"])]
    half = len(losses) // 2
    if not np.mean(losses[half:]) < np.mean(losses[:half]):
        raise AssertionError(f"leg 2: the loss did not fall: {losses}")
    mvt.init(device=device, local_workers=1)
    try:
        ref, ref_losses, _ = mh_w2v_run(mvt, sz, lambda i: True,
                                        lambda: None)
        with mvt.worker(0):
            ref_in, ref_out = ref.input_table.get(), ref.output_table.get()
    finally:
        stop_runtime(mvt)
    w_gap = 0.0
    for name, ref_t in (("in", ref_in), ("out", ref_out)):
        got = np.load(os.path.join(outdir, f"w2v_{name}.npy"))
        np.testing.assert_allclose(got, ref_t, rtol=W2V_RTOL, atol=W2V_ATOL,
                                   err_msg=f"leg 2: w_{name} off the "
                                           f"one-process run")
        w_gap = max(w_gap, float(np.abs(got - ref_t).max()))
    np.testing.assert_allclose(losses, [ref_losses[i] for i in
                                        range(sz["blocks"])], rtol=W2V_RTOL)
    secs = max(x["w2v"]["seconds"] for x in res)
    m["2_word2vec"] = {"blocks": sz["blocks"], "losses": losses,
                       "words_per_s": res[0]["w2v"]["words"] / secs,
                       "seconds": secs, "max_abs_gap_vs_one_process": w_gap}

    # leg 3: the restore is the snapshot bit for bit; the aggregate is the
    # reference's sum: each rank's workers in slot order, then the ranks'
    # sums in rank order
    if len({x["pre_snapshot_digest"] for x in res}
           | {x["restored_digest"] for x in res}) != 1:
        raise AssertionError("leg 3: the restored table is not the snapshot")
    n = sz["agg"]
    ranks = [mh_agg_value(r * 2, n) + mh_agg_value(r * 2 + 1, n)
             for r in range(MH_RANKS)]
    want = ranks[0]
    for r in ranks[1:]:
        want = want + r
    if {x["aggregate_digest"] for x in res} != {mh_digest(want)}:
        raise AssertionError("leg 3: aggregate is not the reference-order sum")
    m["3_checkpoint"] = {"snapshot_s": res[0]["snapshot_s"],
                         "restore_s": res[0]["restore_s"],
                         "table_mb": sz["num_row"] * sz["num_col"] * 4 / 1e6}
    m["3_aggregate"] = {"floats": n, "ms": [x["aggregate_ms"] for x in res],
                        "on": [x["aggregate_on"] for x in res]}
    launches = {f"rank{x['rank']}": x["launches"] for x in res}
    for rank, counts in launches.items():
        for k, c in counts.items():
            # the wrappers count launches of the kernels: on the card only
            if device == "cuda" and c <= 0:
                raise AssertionError(f"{k}: no launch in {rank}")
    # every rank replays every block's transaction, so each runs them all
    from multiverso_tpu_torch.models.word2vec import Word2VecConfig
    config = Word2VecConfig(**mh_w2v_config(sz))
    for x in res:
        launches[f"rank{x['rank']}"]["sgns_chunk"] = check_sgns_launches(
            f"leg 2 in rank {x['rank']}", x["w2v"]["sgns_launches"],
            sz["blocks"] * w2v_chunks(config, config.block_tokens), device)
    m["phase_s"] = time.perf_counter() - t_phase
    return m, launches


# -- phase 20: sequence parallelism and the native layer -----------------------
# Leg 1: four ranks of one gloo world on the one card, each a process of
# this script (``--ring-rank``), run ring attention and the Ulysses reshard
# on their blocks of one global sequence; rank 0 holds them against
# ``reference_attention`` on the gathered inputs. Then the long-context LM
# twin (its example, self-launching 4 ranks). Leg 2: the native library
# from this process through ctypes, its C clients, codecs and reader.
SP_RANKS = 4
SP_T, SP_B, SP_H, SP_D = 16_384, 1, 8, 64   # global T; 4,096 a rank, fp32
SP_GRAD_T = 2_048                           # the backward's global T
SP_REPS = 3                                 # timed runs (after a warm-up)
SP_FWD_TOL = 1e-4                           # ring vs reference, abs and rel
SP_GRAD_TOL = 1e-3                          # dq, dk, dv, d(rel), abs and rel
SP_SEED = 20
SP_S = 600                                  # a rank's limit
LM_CONFIG = dict(seq=256, dim=64, heads=4, vocab=32, batch=8, steps=300,
                 lr=1e-2)                   # the JAX example's defaults
LM_TABLE_GAP = 1e-6                         # init + (trained - init) in fp32
NATIVE_ROUNDS = 64                          # C API 1024-row Add + Get rounds
NATIVE_PY_ROUNDS = 16                       # the same through the Python API
NATIVE_SEED = 20
CODEC_FLOATS = 1_000_000
LIBSVM_LINES = 100_000


def sp_inputs(T: int, dev, seed: int, n: int = 3):
    """``n`` global (B, T, H, D) fp32 tensors drawn on ``dev`` from
    ``seed``: every rank draws the same ones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((SP_B, T, SP_H, SP_D), generator=g, device=dev)
            for _ in range(n)]


def sp_rel(T: int, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return 0.5 * torch.randn((SP_H, 2 * T - 1), generator=g, device=dev)


def sp_rel_bias(rel, T: int):
    def bias_fn(q_pos, kv_pos):
        return rel[:, q_pos[:, None] - kv_pos[None, :] + T - 1][None]
    return bias_fn


def sp_gap(got, want) -> dict:
    """max |got - want|, and max |got - want| / (1 + |want|): within a
    tolerance ``tol`` (abs and rel) exactly when the second is <= tol."""
    d = (got - want).abs()
    return {"max_abs_err": float(d.max()),
            "max_rel_excess": float((d / (1.0 + want.abs())).max())}


def ring_rank_main(argv) -> int:
    """``chip_smoke.py --ring-rank RANK COORD_PORT OUTDIR``: one rank of
    phase 20's ring world (its spec in ``OUTDIR/spec.json``). Writes
    ``OUTDIR/rank<R>.json``."""
    import torch.distributed as dist
    from multiverso_tpu_torch.parallel import ring

    rank, coord, outdir = int(argv[0]), argv[1], argv[2]
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    sz, world = spec["sizes"], spec["world"]
    dev = torch.device(spec["device"])
    on_card = dev.type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{coord}",
                            world_size=world, rank=rank)
    group = dist.new_group(backend="gloo")   # the ring's own group
    out = {"rank": rank, "device": str(dev)}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def timed(fn, reps=SP_REPS):
        """(median ms over ``reps`` runs after one warm-up, last result);
        every rank starts each run together."""
        res = fn()
        times = []
        for _ in range(reps):
            dist.barrier(group)
            sync()
            a = time.perf_counter()
            res = fn()
            sync()
            times.append((time.perf_counter() - a) * 1e3)
        return float(np.median(times)), res

    def gather(t):
        """Rank 0: the ranks' blocks of ``t`` (host), in rank order."""
        host = t.detach().to("cpu").contiguous()
        parts = ([torch.empty_like(host) for _ in range(world)]
                 if rank == 0 else None)
        dist.gather(host, parts, dst=0, group=group)
        return parts

    T = sz["T"]
    tl = T // world
    lo = rank * tl
    q, k, v = sp_inputs(T, dev, SP_SEED)
    qb, kb, vb = (x[:, lo:lo + tl].contiguous() for x in (q, k, v))
    rel = sp_rel(T, dev, SP_SEED + 1)
    cases = {"plain": {}, "causal": {"causal": True},
             "rel_bias": {"bias_fn": sp_rel_bias(rel, T)}}
    out["bringup_s"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    blocks = {}
    with torch.no_grad():
        for name, kw in cases.items():
            ms, o = timed(lambda: ring.ring_attention(qb, kb, vb, group, **kw))
            out[f"fwd_{name}_ms"] = ms
            blocks[name] = gather(o)
        # Ulysses: heads split over the ranks, the whole sequence each
        def ulysses():
            qh, kh, vh = (ring.ulysses_all_to_all(t, group) for t in (qb, kb, vb))
            return ring.ulysses_all_to_all(ring.reference_attention(qh, kh, vh),
                                           group, to_heads=False)
        out["ulysses_ms"], o = timed(ulysses)
        blocks["ulysses"] = gather(o)
        # one hop of the K/V block, and its two parts: the host staging
        # (device to host and back) and the gloo exchange of host tensors
        out["hop_ms"], _ = timed(lambda: ring.ring_shift((kb, vb), group))
        out["hop_staging_ms"], _ = timed(
            lambda: [t.to("cpu").to(dev) for t in (kb, vb)])
        hk = [t.to("cpu") for t in (kb, vb)]
        out["hop_gloo_ms"], _ = timed(lambda: ring.ring_shift(hk, group))
        out["hop_mb"] = 2 * kb.numel() * kb.element_size() / 2**20
    out["ring_peak_mb"] = (torch.cuda.max_memory_allocated(dev) / 2**20
                           if on_card else None)

    # the backward at SP_GRAD_T: d sum(out * w), causal with a relative bias
    Tg = sz["grad_T"]
    tg = Tg // world
    glo = rank * tg
    gq, gk, gv, gw = sp_inputs(Tg, dev, SP_SEED + 2, n=4)
    grel = sp_rel(Tg, dev, SP_SEED + 3)
    leaves = [x[:, glo:glo + tg].contiguous().requires_grad_(True)
              for x in (gq, gk, gv)]
    rel_leaf = grel.clone().requires_grad_(True)
    w_blk = gw[:, glo:glo + tg]

    def fwd_bwd():
        for t in leaves + [rel_leaf]:
            t.grad = None
        o = ring.ring_attention(*leaves, group, causal=True,
                                bias_fn=sp_rel_bias(rel_leaf, Tg))
        (o * w_blk).sum().backward()
        return o

    with torch.no_grad():
        out["grad_T_fwd_ms"], _ = timed(lambda: ring.ring_attention(
            *leaves, group, causal=True, bias_fn=sp_rel_bias(grel, Tg)))
    out["fwd_bwd_ms"], _ = timed(fwd_bwd)
    grads = {n: gather(t.grad) for n, t in zip(("dq", "dk", "dv"), leaves)}
    drel = gather(rel_leaf.grad)   # each rank's share of d(rel)
    dist.barrier(group)

    inputs = [gather(t) for t in (qb, kb, vb)]
    grad_inputs = [gather(t) for t in leaves + [w_blk]]

    if rank == 0:
        # the oracle on this rank, on the card, from the gathered inputs
        q, k, v = (torch.cat(p, dim=1).to(dev) for p in inputs)
        gq, gk, gv, gw = (torch.cat(p, dim=1).to(dev) for p in grad_inputs)
        checks = {}
        for name, kw in list(cases.items()) + [("ulysses", {})]:
            got = torch.cat(blocks[name], dim=1).to(dev)
            with torch.no_grad():
                if name == "plain":
                    sync()
                    a = time.perf_counter()
                    want = ring.reference_attention(q, k, v)
                    sync()
                    out["reference_ms"] = (time.perf_counter() - a) * 1e3
                elif name == "ulysses":
                    want = ring.reference_attention(q, k, v)
                else:
                    want = ring.reference_attention(q, k, v, **kw)
            checks[name] = sp_gap(got, want)
            del got, want
            if on_card:
                torch.cuda.empty_cache()
        qf, kf, vf = (x.clone().requires_grad_(True) for x in (gq, gk, gv))
        relf = grel.clone().requires_grad_(True)
        ref = ring.reference_attention(qf, kf, vf, causal=True,
                                       bias_fn=sp_rel_bias(relf, Tg))
        (ref * gw).sum().backward()
        for n, t in zip(("dq", "dk", "dv"), (qf, kf, vf)):
            checks[n] = sp_gap(torch.cat(grads[n], dim=1).to(dev), t.grad)
        checks["drel"] = sp_gap(torch.stack(drel).sum(0).to(dev), relf.grad)
        out["checks"] = checks
    out["peak_mb"] = (torch.cuda.max_memory_allocated(dev) / 2**20
                      if on_card else None)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier(group)
    dist.destroy_process_group()
    return 0


def ring_leg(device: str, scratch: str, sz: dict) -> dict:
    """Phase 20 leg 1: the ring world's ranks, then their checks."""
    t0 = time.perf_counter()
    outdir = os.path.join(scratch, "ring")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"sizes": sz, "device": device, "world": SP_RANKS}, f)
    coord = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(outdir, f"rank{r}.log"), "w")
            for r in range(SP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ring-rank", str(r),
         str(coord), outdir], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=here) for r in range(SP_RANKS)]
    try:
        codes = [p.wait(timeout=SP_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        if code != 0:
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                tail = "".join(f.readlines()[-40:])
            raise AssertionError(f"ring rank {r} exited {code}:\n{tail}")
    res = []
    for r in range(SP_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    checks = res[0]["checks"]
    for name, c in checks.items():
        tol = SP_GRAD_TOL if name.startswith("d") else SP_FWD_TOL
        if not c["max_rel_excess"] <= tol:
            raise AssertionError(f"ring {name}: off the reference by "
                                 f"{c['max_abs_err']} (tolerance {tol} abs "
                                 f"and rel)")
    slowest = {k: max(x[k] for x in res) for k in res[0]
               if k.endswith("_ms") and k != "reference_ms"}
    return {"world": SP_RANKS, "T": sz["T"], "T_local": sz["T"] // SP_RANKS,
            "grad_T": sz["grad_T"], "B": SP_B, "H": SP_H, "D": SP_D,
            "devices": [x["device"] for x in res],
            "ms_slowest_rank": slowest, "reference_ms": res[0]["reference_ms"],
            "hop_mb": res[0]["hop_mb"], "checks": checks,
            "bringup_s": [x["bringup_s"] for x in res],
            "ring_peak_mb": [x["ring_peak_mb"] for x in res],
            "peak_mb": [x["peak_mb"] for x in res],
            "leg_s": time.perf_counter() - t0}


def lm_leg(device: str, lm: dict) -> dict:
    """Phase 20: the long-context LM twin at the JAX example's defaults
    (its own 4-rank lockstep world); the loss falls, the echo is learnt,
    and the table holds the trained model after the sync."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "long_context_lm", os.path.join(here, "multiverso_tpu_torch",
                                        "examples", "long_context_lm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    rep = example.run(device=device, verbose=False, world=SP_RANKS, **lm)
    losses = rep["losses"]
    first, last = float(np.mean(losses[:25])), float(np.mean(losses[-25:]))
    if not last < first:
        raise AssertionError(f"LM: the loss did not fall ({first} -> {last})")
    if not rep["acc"] > 0.9:
        raise AssertionError(f"LM: final echo accuracy {rep['acc']}")
    if not rep["table_gap"] <= LM_TABLE_GAP:
        raise AssertionError(f"LM: the table is {rep['table_gap']} off the "
                             f"trained model after the sync")
    return {"config": lm, "lag": rep["lag"], "acc": rep["acc"],
            "loss_first25": first, "loss_last25": last,
            "table_gap": rep["table_gap"], "steps_per_s": rep["steps_per_s"],
            "train_s": rep["train_s"], "device": rep["device"],
            "peak_mb": rep["peak_mb"], "leg_s": time.perf_counter() - t0}


def _f32p(a: np.ndarray):
    import ctypes
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    import ctypes
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def native_leg(mvt, rows, device: str, scratch: str, sz: dict) -> tuple:
    """Phase 20 leg 2: the port's native library from this process (C API
    over a configuration-1 matrix, bitwise against a numpy mirror), its C
    clients as child processes, the codecs and the libsvm reader. Returns
    (metrics, row-kernel launches over the C API drive)."""
    import ctypes
    from multiverso_tpu_torch import c_bridge, native
    from multiverso_tpu_torch.config import FLAGS
    from multiverso_tpu_torch.models.logreg import (load_libsvm,
                                                    load_libsvm_native)
    from multiverso_tpu_torch.utils import quantization as qz
    # built at first use: by this leg, or earlier in this process
    t0 = time.perf_counter()
    lib = native.load()
    m = {"load_s": time.perf_counter() - t0,
         "build_s": native.build_seconds.get(native.LIB_NAME)}

    # the C API through ctypes: MV_Init on the card, 1024-row rounds
    stop_runtime(mvt)
    num_row, num_col, batch = sz["num_row"], sz["num_col"], sz["batch"]
    argv = [b"chip_smoke", f"-device={device}".encode()]
    argc = ctypes.c_int(len(argv))
    lib.MV_Init(ctypes.byref(argc), (ctypes.c_char_p * 3)(*argv, None))
    handle = ctypes.c_void_p()
    lib.MV_NewMatrixTable(num_row, num_col, ctypes.byref(handle))
    table = c_bridge._tables[handle.value]
    m["table_device"] = str(table._server_table.data.device)
    if m["table_device"].split(":")[0] != device:
        raise AssertionError(f"C API table on {m['table_device']}")
    mirror = np.zeros((num_row, num_col), np.float32)
    rng = np.random.default_rng(NATIVE_SEED)
    lat = {"c_add": [], "c_get": [], "py_add": [], "py_get": []}

    def drive(via: str, n_rounds: int) -> dict:
        """``n_rounds`` Add+Get rounds through the C API (``via="c"``) or
        the Python API (``"py"``), each Get bitwise against the mirror;
        returns the row-kernel launches of exactly these rounds."""
        zero_launches(rows)
        for k in range(n_rounds):
            ids = rng.integers(0, num_row, batch).astype(np.int32)
            vals = rng.integers(-3, 4, (batch, num_col)).astype(np.float32)
            np.add.at(mirror, ids, vals)
            gids = rng.integers(0, num_row, batch).astype(np.int32)
            out = np.empty((batch, num_col), np.float32)
            a = time.perf_counter()
            if via == "c":
                lib.MV_AddMatrixTableByRows(handle, _f32p(vals), vals.size,
                                            _i32p(ids), batch)
            else:
                table.add(vals, row_ids=ids)
            b = time.perf_counter()
            if via == "c":
                lib.MV_GetMatrixTableByRows(handle, _f32p(out), out.size,
                                            _i32p(gids), batch)
            else:
                out = table.get(gids)
            lat[f"{via}_add"].append((b - a) * 1e3)
            lat[f"{via}_get"].append((time.perf_counter() - b) * 1e3)
            if not np.array_equal(out, mirror[gids]):
                raise AssertionError(f"{via} API round {k}: the Get is off "
                                     f"the mirror")
        return launch_counts(rows)

    launches = drive("c", sz["rounds"])        # the C API alone
    py_launches = drive("py", sz["py_rounds"])   # the Python API alone
    whole = np.empty((num_row, num_col), np.float32)
    lib.MV_GetMatrixTableAll(handle, _f32p(whole), whole.size)
    if not np.array_equal(whole, mirror):
        raise AssertionError("C API: the whole table is off the mirror")
    lib.MV_ShutDown()
    FLAGS.reset()
    del whole, mirror
    if device == "cuda":
        for kname, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{kname}: no launch through the C API")
    m["c_api"] = {"rounds": sz["rounds"], "py_rounds": sz["py_rounds"],
                  "shape": [num_row, num_col], "batch": batch,
                  "py_api_launches": py_launches,
                  **{f"{k}_ms": percentiles(v) for k, v in lat.items()}}

    # the C clients: they embed Python, which needs a shared libpython
    cfg = native.embed_config()
    ok, why = native.embed_supported()
    m["embed"] = {"Py_ENABLE_SHARED": cfg["Py_ENABLE_SHARED"],
                  "LDLIBRARY": cfg["LDLIBRARY"],
                  "libpython": str(native.shared_libpython()),
                  "clients_run": ok, "why_not": why}
    print(f"native: Py_ENABLE_SHARED={cfg['Py_ENABLE_SHARED']} "
          f"LDLIBRARY={cfg['LDLIBRARY']} shared libpython "
          f"{native.shared_libpython()}; C clients "
          f"{'run' if ok else 'left out: ' + why}", flush=True)
    if ok:
        args = [] if device == "cuda" else [f"-device={device}"]
        for name, marker in (("test_c_api", "c_api smoke test passed"),
                             ("test_lua_ffi", "lua ffi replay passed")):
            a = time.perf_counter()
            binary = native.build_client(name)
            b = time.perf_counter()
            proc = subprocess.run([str(binary)] + args,
                                  env=native.client_env(),
                                  cwd=str(native.BUILD_DIR),
                                  capture_output=True, text=True,
                                  timeout=CLIENT_S)
            if proc.returncode != 0 or marker not in proc.stdout:
                raise AssertionError(f"{name} exited {proc.returncode}:\n"
                                     f"{(proc.stdout + proc.stderr)[-3000:]}")
            m[name] = {"build_s": b - a, "run_s": time.perf_counter() - b}

    # the codecs: native and numpy payloads byte for byte
    crng = np.random.default_rng(NATIVE_SEED + 1)
    sparse = np.zeros(sz["codec_floats"], np.float32)
    nz = crng.choice(sparse.size, sparse.size // 100, replace=False)
    sparse[nz] = crng.standard_normal(nz.size, dtype=np.float32)
    dense = crng.standard_normal(sz["codec_floats"], dtype=np.float32)
    codec = {}
    for name, enc in (("sparse", lambda x, f: qz.sparse_encode(x, force_numpy=f)),
                      ("dense", lambda x, f: qz.sparse_encode(x, force_numpy=f)),
                      ("quant4", lambda x, f: qz.quant_encode(
                          x, 4, force_numpy=f))):
        x = sparse if name == "sparse" else dense
        a = time.perf_counter()
        got = enc(x, False)
        b = time.perf_counter()
        want = enc(x, True)
        c = time.perf_counter()
        if got != want:
            raise AssertionError(f"codec {name}: native and numpy payloads "
                                 f"differ")
        codec[name] = {"bytes": len(got), "native_ms": (b - a) * 1e3,
                       "numpy_ms": (c - b) * 1e3}
    m["codecs"] = codec

    # the libsvm reader: native against the Python parser
    path = os.path.join(scratch, "native.libsvm")
    lrng = np.random.default_rng(NATIVE_SEED + 2)
    with open(path, "w") as f:
        for _ in range(sz["libsvm_lines"]):
            feats = np.sort(lrng.choice(1 << 20, int(lrng.integers(1, 40)),
                                        replace=False))
            vals = lrng.standard_normal(feats.size)
            f.write(f"{int(lrng.integers(0, 2))} " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(feats, vals)) + "\n")
    a = time.perf_counter()
    nat = load_libsvm_native(path, max_nnz=39)
    b = time.perf_counter()
    ref = load_libsvm("file://" + path, max_nnz=39)   # the Python parser
    c = time.perf_counter()
    if nat is None or any(not np.array_equal(nat[k], ref[k])
                          for k in ("y", "idx", "val")):
        raise AssertionError("load_libsvm_native is off the Python parser")
    m["libsvm"] = {"lines": sz["libsvm_lines"], "native_s": b - a,
                   "python_s": c - b}
    return m, launches


def seqpar_native_phase(mvt, rows, device: str, scratch: str,
                        sizes=None) -> tuple:
    """Phase 20: leg 1 (the ring world, then the LM twin) and leg 2 (the
    native layer). Returns (metrics, row-kernel launches of leg 2).
    ``sizes`` shrinks it for a CPU rehearsal."""
    sz = dict(T=SP_T, grad_T=SP_GRAD_T, num_row=ROWS, num_col=COLS,
              batch=BATCH, rounds=NATIVE_ROUNDS, py_rounds=NATIVE_PY_ROUNDS,
              codec_floats=CODEC_FLOATS, libsvm_lines=LIBSVM_LINES,
              lm=LM_CONFIG)
    sz.update(sizes or {})
    t0 = time.perf_counter()
    m = {"1_ring": ring_leg(device, scratch, sz)}
    m["1_lm"] = lm_leg(device, sz["lm"])
    m["2_native"], launches = native_leg(mvt, rows, device, scratch, sz)
    m["phase_s"] = time.perf_counter() - t0
    return m, launches


KERNELS = {
    "scatter_add_rows":"multiverso_tpu/ops/pallas_rows.py:172",
    "gather_rows": "multiverso_tpu/ops/pallas_rows.py:107",
    "scatter_add_rows_coalesced": "multiverso_tpu/ops/pallas_rows.py:296",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=256,
                        help="1024-row Add+Get rounds per worker thread")
    parser.add_argument("--client", action="store_true",
                        help="run as one client process of phase 14 (the "
                             "script starts these itself)")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--durable-primary"]:
        return durable_primary_main(argv[1:])
    if argv[:1] == ["--multihost-rank"]:
        return multihost_rank_main(argv[1:])
    if argv[:1] == ["--ring-rank"]:
        return ring_rank_main(argv[1:])
    args = parser.parse_args(argv)
    if args.client:
        return client_main()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this check runs on the "
              "card only", file=sys.stderr)
        return 1
    # snapshots, the corpus and the logreg files; removed on the way out
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        return smoke(args, scratch)


def smoke(args, scratch: str) -> int:
    started = time.perf_counter()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch import native
    from multiverso_tpu_torch.ops import kernels, rows
    from multiverso_tpu_torch.parallel import mesh

    # 1. the card and the toolchain
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    nvcc = kernels.find_nvcc()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{run([nvcc, '--version']).splitlines()[-1]}", flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # 2. build
    for lib in ("rows", "sgns"):
        t0 = time.perf_counter()
        kernels.load(lib)
        print(f"built csrc/{lib}.cu in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in kernels.build_logs.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    # the native library (C API, codecs, reader): g++ at first use, here
    t0 = time.perf_counter()
    native.load()
    print(f"built native/ (libmultiverso_tpu.so) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels
    results, floor = kernel_phase(rows, mesh, dev)
    sgns_chain = sgns_phase(dev, card)
    print(f"launch floor: {floor} ms a call of fill_ on a one-element tensor, "
          f"back to back ({card})", flush=True)

    # 4. the coalesced scatter; its main path is the word2vec push
    err, times = coalesced_phase(rows, mesh, dev, card)
    push = times["w2v_push"]
    results["scatter_add_rows_coalesced"] = {
        "max_abs_err": err, "ms": push["coalesced_ms"],
        "plain_ms": push["plain_ms"], "library_ms": push["index_add_ms"],
        "bound_ms": push["bound_ms"], "bound_by": push["bound_by"]}

    # 5. the parameter server; its tables snapshotted, then restored
    snap, ps_dir = {}, os.path.join(scratch, "ps")
    metrics, launches = ps_phase(
        mvt, rows, "cuda", args.rounds,
        snapshot=lambda tables: snap.update(snapshot_tables(tables, ps_dir)))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: no launch on the main path")
    print(f"PS path on {card}: {json.dumps(metrics)}", flush=True)
    ps_ckpt = ps_restore(mvt, "cuda", ps_dir, snap)
    del snap
    print(f"PS checkpoint on {card}: the 1M x 50 SGD and AdaGrad matrices "
          f"(4-worker state) and the array table stored and restored after a "
          f"restart, bitwise equal: {json.dumps(ps_ckpt)}", flush=True)
    print(f"launches per 1024-row Add: scatter "
          f"{launches['scatter_add_rows'] / metrics['matrix_adds']:.3f}; per "
          f"1024-row Get: gather {launches['gather_rows'] / metrics['matrix_gets']:.3f}")
    print(f"table API on the card: {api_phase(mvt)} checks equal to numpy",
          flush=True)

    # 6. word2vec
    w2v, w2v_launches = word2vec_phase(mvt, rows, "cuda", card)
    for k, n in w2v_launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: no launch on the word2vec path")
    print(f"word2vec on {card}: {json.dumps(w2v)}", flush=True)
    print(f"launches over the word2vec phase (six runs of "
          f"{w2v['ps_submissions']} group-{W2V_GROUP} submissions, three "
          f"with COALESCE on, plus two group-1 submissions, one with it on): "
          f"{json.dumps(w2v_launches)}", flush=True)
    launches["scatter_add_rows_coalesced"] = w2v_launches["scatter_add_rows_coalesced"]

    # 7. the consistency servers
    finals = {}
    for mode, jitter in (("bsp", 0.0), ("ssp2", 0.0), ("deterministic", 0.0),
                         ("deterministic", 0.002)):
        m, finals[(mode, jitter)], mode_launches = modes_phase(
            mvt, rows, "cuda", mode, jitter_s=jitter)
        print(f"{mode} PS (jitter {jitter} s) on {card}: {json.dumps(m)}; "
              f"launches over the drive: {json.dumps(mode_launches)}", flush=True)
        for k, n in mode_launches.items():
            if n <= 0:
                raise AssertionError(f"{k}: no launch under {mode}")
    a, b = finals[("deterministic", 0.0)], finals[("deterministic", 0.002)]
    if not np.array_equal(a, b):
        raise AssertionError(f"-deterministic: two runs differ (max |diff| "
                             f"{float(np.abs(a - b).max())})")
    print("deterministic PS: the two runs' final tables are bitwise equal",
          flush=True)
    del finals, a, b

    # 8. word2vec's staged path under the gated and deterministic servers
    staged, staged_launches = staged_word2vec_phase(mvt, rows, "cuda", card)
    print(f"staged word2vec on {card}: {json.dumps(staged)}", flush=True)
    print(f"launches over the staged word2vec runs: {json.dumps(staged_launches)}",
          flush=True)
    for k, n in staged_launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: no launch on the staged word2vec path")

    # 9. logistic regression
    lr_metrics, lr_launches = logreg_phase(mvt, rows, "cuda", card)
    print(f"logreg on {card}: {json.dumps(lr_metrics)}; launches over the "
          f"phase: {json.dumps(lr_launches)}", flush=True)

    # 10. checkpoints: resume exactness, word2vec and logreg from files
    resume, resume_launches = resume_phase(mvt, rows, "cuda",
                                           os.path.join(scratch, "resume"))
    print(f"resume on {card}: {resume['rounds']} rounds uninterrupted equal "
          f"bitwise to {resume['rounds'] // 2} + {resume['rounds'] // 2} "
          f"around a restart: {json.dumps(resume)}; launches over the resumed "
          f"rounds: {json.dumps(resume_launches)}", flush=True)
    w2v_file, w2v_file_launches = word2vec_file_phase(mvt, rows, "cuda", card,
                                                      scratch)
    print(f"word2vec from a file on {card}: {json.dumps(w2v_file)}; launches "
          f"over the resumed submissions: {json.dumps(w2v_file_launches)}",
          flush=True)
    lr_file, lr_file_launches = logreg_file_phase(mvt, rows, "cuda", card,
                                                  scratch)
    print(f"logreg from config files on {card}: {json.dumps(lr_file)}; "
          f"launches over the training: {json.dumps(lr_file_launches)}",
          flush=True)
    for what, counts in (("the resumed PS rounds", resume_launches),
                         ("the resumed word2vec submissions", w2v_file_launches)):
        for k, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{k}: no launch on {what}")

    # 11. the device hash KV table
    kv = device_kv_phase(mvt, "cuda", card)
    print(f"device KV on {card}: {json.dumps(kv)}", flush=True)

    # 12. the query plane
    query, query_launches = query_phase(mvt, rows, "cuda", card, scratch)
    print(f"query plane on {card}: {json.dumps(query)}; row-kernel launches "
          f"over the phase (its table fills): {json.dumps(query_launches)}",
          flush=True)

    # 13. model-averaging ASGD: ResNet-32 through one array table
    asgd = asgd_phase(mvt, "cuda", scratch)
    print(f"ASGD ResNet-32 on {card}: {json.dumps(asgd)}", flush=True)

    # 14. serving over the wire: client processes against the card's tables
    serve, serve_launches = serve_phase(mvt, rows, "cuda", card, scratch)
    print(f"serving on {card}: {json.dumps(serve)}", flush=True)
    for leg, counts in serve_launches.items():
        for k, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{k}: no launch in the server over "
                                     f"serving leg {leg}")

    # 15. durable serving: the WAL, crash recovery, failover, replicas, audit
    durable, durable_launches = durable_phase(mvt, rows, "cuda", card, scratch,
                                              serve["1_ps_tcp"])
    print(f"durable serving on {card}: {json.dumps(durable)}; launches in "
          f"this process: {json.dumps(durable_launches)}", flush=True)
    print(f"durable serving phase: {durable['phase_s']:.1f} s ({card})",
          flush=True)
    for leg, kernel in (("2_3_recovery_and_standby", "scatter_add_rows"),
                        ("4_replica_reads", "gather_rows")):
        if durable_launches[leg][kernel] <= 0:
            raise AssertionError(f"{kernel}: no launch over durable {leg}")

    # 16. sharded serving: shard processes on the card, routers here
    sharded, shard_launches = shard_phase(mvt, "cuda", card, scratch,
                                          serve["1_ps_tcp"])
    shard_counts = check_shard_launches(shard_launches)
    print(f"sharded serving on {card}: {json.dumps(sharded)}; row-kernel "
          f"launches in the shard processes: {json.dumps(shard_counts)}",
          flush=True)
    print(f"sharded serving phase: {sharded['phase_s']:.1f} s ({card})",
          flush=True)

    # 17. LDA at the NYTimes shape: the row kernels at rows 1,000 wide
    lda, lda_launches = lda_phase(mvt, rows, "cuda", card, scratch)
    print(f"LDA on {card}: {json.dumps(lda)}; row-kernel launches over the "
          f"full-width run: {json.dumps(lda_launches)}", flush=True)
    print(f"LDA phase: {lda['phase_s']:.1f} s ({card})", flush=True)
    for k, n in lda_launches.items():
        if n <= 0:
            raise AssertionError(f"{k}: no launch on the LDA path")

    # 18. the self-driving control plane: the autopilot over configuration
    # 10's fleet, the knob tuner on a live server
    control, control_launches = control_phase(mvt, rows, "cuda", card,
                                              scratch)
    print(f"control plane phase: {control['phase_s']:.1f} s ({card})",
          flush=True)

    # 19. the multi-process PS: a 2-rank lockstep world on the one card
    multihost, mh_launches = multihost_phase(mvt, "cuda", scratch)
    print(f"multi-process PS on {card}: {json.dumps(multihost)}; row-kernel "
          f"launches by rank: {json.dumps(mh_launches)}", flush=True)
    print(f"multi-process PS phase: {multihost['phase_s']:.1f} s ({card})",
          flush=True)

    # 20. sequence parallelism (the ring, Ulysses, the LM twin) and the
    # native layer (the C API, its clients, codecs and reader)
    seqpar, native_launches = seqpar_native_phase(mvt, rows, "cuda", scratch)
    print(f"ring attention on {card}: {json.dumps(seqpar['1_ring'])}",
          flush=True)
    print(f"long-context LM twin on {card}: {json.dumps(seqpar['1_lm'])}",
          flush=True)
    print(f"native layer on {card}: {json.dumps(seqpar['2_native'])}; "
          f"row-kernel launches through the C API: "
          f"{json.dumps(native_launches)}", flush=True)
    print(f"sequence-parallel and native phase: {seqpar['phase_s']:.1f} s "
          f"({card})", flush=True)

    # 21. the kernel line, then the verdict
    table = []
    for k, where in KERNELS.items():
        r = results[k]
        print(f"kernel {k}: launches={launches[k]} "
              f"lda_launches={lda_launches.get(k, 0)} kernel_ms={r['ms']} "
              f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']} launch_floor_ms={floor} ({card})")
        table.append({"name": k, "route": "cuda",
                      "source": "multiverso_tpu_torch/csrc/rows.cu",
                      "replaces": where, "launches": launches[k],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                      "launch_floor_ms": floor,
                      # phase 17: launches over the LDA run at full width
                      "lda_launches": lda_launches.get(k, 0),
                      # phase 16: launches in the shard processes, by role
                      "shard_process_launches": {
                          role: c.get(k, 0)
                          for role, c in shard_counts.items()},
                      # phase 18: leg 1's shard processes by role, leg 2's
                      # server (this process)
                      "control_plane_launches": {
                          **{f"autopilot/{role}": c.get(k, 0) for role, c
                             in control_launches["1_autopilot"].items()},
                          "tuner/server": control_launches["2_tuner"].get(
                              k, 0)},
                      # phase 19: launches in each rank of the world
                      "multihost_rank_launches": {
                          rank: c.get(k, 0) for rank, c in mh_launches.items()},
                      # phase 20: launches through the C API
                      "c_api_launches": native_launches.get(k, 0)})
    # the chain's launches on the main paths, each phase's counter zeroed
    # before it and held there to KERNELS a chunk step it ran (phase 3's
    # own timing calls are not among them)
    sgns_launches = {
        "word2vec_ps_submissions": w2v_launches["sgns_chunk"],
        "word2vec_corpus_step": w2v_launches["sgns_chunk_corpus_step"],
        "word2vec_profiled_submissions":
            w2v_launches["sgns_chunk_profiled_submissions"],
        "staged_word2vec": staged_launches["sgns_chunk"],
        "served_word2vec_client": serve["5_word2vec"]["client_sgns_launches"]}
    print(f"kernel sgns_chunk: launches={json.dumps(sgns_launches)} "
          f"multihost_rank_launches="
          f"{json.dumps({r: c['sgns_chunk'] for r, c in mh_launches.items()})} "
          f"chunk_ms={ {k: v['ms'] for k, v in sgns_chain.items()} } "
          f"plain_ms={ {k: v['plain_ms'] for k, v in sgns_chain.items()} } "
          f"bound_ms={ {k: v['bound_ms'] for k, v in sgns_chain.items()} } "
          f"({card})")
    table.append({"name": "sgns_chunk", "route": "cuda",
                  "source": "multiverso_tpu_torch/csrc/sgns.cu",
                  "replaces": "none (the JAX block step is one jit)",
                  "launches": sgns_launches,
                  "multihost_rank_launches": {
                      rank: c["sgns_chunk"] for rank, c in mh_launches.items()},
                  "bound_by": "bytes", "launch_floor_ms": floor,
                  "spaces": sgns_chain})
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s, the build included",
          flush=True)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
