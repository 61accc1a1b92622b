"""LogisticRegression data plumbing: config files + streaming sample readers
(port of ``multiverso_tpu/models/lr_io.py``; host numpy, the same code).

Reference capability (not copied):

* ``Configure`` — key=value config files with typed fields and defaults
  (``Applications/LogisticRegression/src/configure.h:9-104``); the binary
  ran as ``logistic_regression config_file``.
* ``SampleReader`` + ``WeightedSampleReader`` + ``BSparseSampleReader`` —
  a background thread parses ';'-separated input files into a preallocated
  ring of samples; trainers pull rows and free them
  (``Applications/LogisticRegression/src/reader.cpp``).

Readers produce PADDED MINIBATCH ARRAYS, not row objects: static-shape
``{y, idx, val}`` (sparse, idx=-1 padded) or ``{y, x}`` (dense) blocks,
parsed straight into two preallocated numpy batch buffers double-buffered
by ``AsyncBuffer`` (the prefetcher fills batch N+1 while the model trains
on batch N). Files are URIs: any registered Stream scheme works. Parsing
fans out over ``omp_threads`` host threads (the flag the reference used
for its OMP loops). The readers stay in numpy: no torch op runs on their
threads.

Divergence from the reference, as in the JAX package: readers inject no
bias feature (the models carry the bias as a separate weight column), and
``PSLogReg`` derives touched keys from the batch's ``idx``.

The ``bsparse`` binary record (little-endian, mirroring the reference's
field set, configure.h:66-68): ``count:uint64 | label:int32 |
weight:float64 | keys:uint64 × count``; each key contributes value
``weight``. ``write_bsparse`` produces the format for tooling and tests.
"""

from __future__ import annotations

import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from multiverso_tpu_torch import config as config_mod
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch import log
from multiverso_tpu_torch.utils import AsyncBuffer


# -- config files ------------------------------------------------------------

class Configure:
    """key=value config file (reference ``Configure``). Unknown keys fatal,
    like the reference's CHECK on ParseValue; '#' starts a comment. Fields
    and defaults mirror ``configure.h:20-97``."""

    _FIELDS: Dict[str, Any] = {
        "input_size": 0,
        "output_size": 1,
        "sparse": False,
        "train_epoch": 1,
        "minibatch_size": 20,
        "read_buffer_size": 2048,
        "show_time_per_sample": 10000,
        "regular_coef": 0.0005,
        "learning_rate": 0.8,
        "learning_rate_coef": 1e6,
        "alpha": 0.005,
        "beta": 1.0,
        "lambda1": 5.0,
        "lambda2": 0.002,
        "init_model_file": "",
        "train_file": "train.data",
        "reader_type": "default",
        "test_file": "",
        "output_model_file": "logreg.model",
        "output_file": "logreg.output",
        "use_ps": False,
        "pipeline": True,
        "sync_frequency": 1,
        "updater_type": "default",
        "objective_type": "default",
        "regular_type": "default",
        # rebuild-only knob: padded nonzeros per sparse sample (static shapes)
        "max_nnz": 64,
    }

    def __init__(self, config_file: str) -> None:
        for key, default in self._FIELDS.items():
            setattr(self, key, default)
        reader = mv_io.TextReader(config_file)
        try:
            while (line := reader.get_line()) is not None:
                self._set_line(line, config_file)
        finally:
            reader.close()
        if not self.input_size:
            log.fatal("Configure: input_size is required (%s)", config_file)

    def _set_line(self, line: str, config_file: str) -> None:
        text = line.split("#", 1)[0].strip()
        if not text:
            return
        key, sep, raw = text.partition("=")
        key, raw = key.strip(), raw.strip()
        if not sep or key not in self._FIELDS:
            log.fatal("Configure: bad line %r in %s", line, config_file)
        default = self._FIELDS[key]
        if isinstance(default, bool):
            value: Any = raw.lower() in ("true", "1", "yes", "on")
        elif isinstance(default, int):
            value = int(raw)
        elif isinstance(default, float):
            value = float(raw)
        else:
            value = raw
        setattr(self, key, value)

    def model_config(self):
        """Map the app-level file onto :class:`LogRegConfig`."""
        from multiverso_tpu_torch.models.logreg import LogRegConfig
        objective = {"default": "sigmoid"}.get(self.objective_type,
                                               self.objective_type)
        regular = {"default": "none"}.get(self.regular_type,
                                          self.regular_type.lower())
        return LogRegConfig(
            input_size=self.input_size, output_size=self.output_size,
            objective=objective, regular=regular,
            regular_coef=self.regular_coef, lr=self.learning_rate,
            minibatch=self.minibatch_size, sparse=self.sparse,
            max_nnz=self.max_nnz, use_ps=self.use_ps,
            sync_frequency=self.sync_frequency, pipeline=self.pipeline,
            updater_type=self.updater_type, lr_coef=self.learning_rate_coef,
            alpha=self.alpha, beta=self.beta, lambda1=self.lambda1,
            lambda2=self.lambda2)


# -- sample parsing ----------------------------------------------------------

def _parse_default(line: str, sparse: bool, max_nnz: int, input_size: int):
    """libsvm sparse ``label k:v …`` / dense ``label v v …``."""
    if sparse:
        from multiverso_tpu_torch.models.logreg import parse_libsvm_line
        return parse_libsvm_line(line, max_nnz)
    parts = line.split()
    label = int(float(parts[0]))
    x = np.zeros(input_size, np.float32)
    vals = np.asarray(parts[1:input_size + 1], np.float32)
    x[:len(vals)] = vals
    return label, x, None


def _parse_weight(line: str, sparse: bool, max_nnz: int, input_size: int):
    """First column ``label:weight``; feature values scaled by weight
    (reference WeightedSampleReader::ParseLine)."""
    head, _, rest = line.partition(" ")
    label_s, _, weight_s = head.partition(":")
    weight = float(weight_s) if weight_s else 1.0
    label, feat, val = _parse_default(f"{label_s} {rest}", sparse, max_nnz,
                                      input_size)
    if val is not None:
        return label, feat, val * np.float32(weight)
    return label, feat * np.float32(weight), None


class SampleReader:
    """Streaming minibatch reader with AsyncBuffer prefetch.

    ``files``: ';'-separated URIs (any Stream scheme). One epoch =
    ``for batch in reader.batches(): …``; call ``reset()`` (or use
    ``epochs(n)``) to rewind. Batches are dicts of numpy views sliced to
    the actual row count — consume before the next ``batches()`` step
    (double-buffer contract: one batch is valid while the next prefetches).
    """

    def __init__(self, files: str, minibatch: int, input_size: int,
                 sparse: bool = False, max_nnz: int = 64,
                 parse: Optional[Callable] = None) -> None:
        self.files = [f for f in files.split(";") if f]
        if not self.files:
            log.fatal("SampleReader: no input files in %r", files)
        self.minibatch = int(minibatch)
        self.input_size = int(input_size)
        self.sparse = bool(sparse)
        self.max_nnz = int(max_nnz)
        self._parse = parse or _parse_default
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, config_mod.get_flag("omp_threads")),
            thread_name_prefix="mv-reader")
        self._reader: Optional[mv_io.TextReader] = None
        self._file_idx = 0
        self._eof = False
        self._io_lock = threading.Lock()
        self._open_next_file(first=True)
        self._buffer = AsyncBuffer(self._alloc(), self._alloc(), self._fill)

    # -- buffers -----------------------------------------------------------
    def _alloc(self) -> Dict[str, np.ndarray]:
        b = self.minibatch
        buf: Dict[str, np.ndarray] = {"y": np.zeros(b, np.int32),
                                      "count": np.zeros((), np.int64)}
        if self.sparse:
            buf["idx"] = np.full((b, self.max_nnz), -1, np.int32)
            buf["val"] = np.zeros((b, self.max_nnz), np.float32)
        else:
            buf["x"] = np.zeros((b, self.input_size), np.float32)
        return buf

    # -- stream management ---------------------------------------------------
    def _open_next_file(self, first: bool = False) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if first:
            self._file_idx = 0
        if self._file_idx < len(self.files):
            self._reader = mv_io.TextReader(self.files[self._file_idx])
            self._file_idx += 1
        else:
            self._eof = True

    def _next_lines(self, n: int) -> List[str]:
        """Up to n non-empty lines, advancing across the file list."""
        lines: List[str] = []
        while len(lines) < n and not self._eof:
            line = self._reader.get_line() if self._reader else None
            if line is None:
                self._open_next_file()
                continue
            if line.strip():
                lines.append(line)
        return lines

    # -- prefetch fill -------------------------------------------------------
    def _fill(self, buf: Dict[str, np.ndarray]) -> None:
        with self._io_lock:
            lines = self._next_lines(self.minibatch)
        parsed = list(self._pool.map(
            lambda ln: self._parse(ln, self.sparse, self.max_nnz,
                                   self.input_size), lines))
        for i, (label, feat, val) in enumerate(parsed):
            buf["y"][i] = label
            if self.sparse:
                buf["idx"][i] = feat
                buf["val"][i] = val
            else:
                buf["x"][i] = feat
        buf["count"][...] = len(parsed)

    # -- API ---------------------------------------------------------------
    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of full-or-partial minibatches."""
        while True:
            buf = self._buffer.get()
            count = int(buf["count"])
            if count == 0:
                if self._eof:
                    return
                continue  # stale pre-reset fill; the next one has data
            yield {k: v[:count] for k, v in buf.items() if k != "count"}
            if count < self.minibatch and self._eof:
                return

    def epochs(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for e in range(n):
            if e > 0:
                self.reset()
            yield from self.batches()

    def reset(self) -> None:
        """Rewind to the first file (reference SampleReader::Reset: only
        legal at EOF — the prefetcher must be parked)."""
        with self._io_lock:
            if not self._eof:
                log.fatal("SampleReader.reset before end of epoch")
            self._eof = False
            self._open_next_file(first=True)

    def close(self) -> None:
        self._buffer.stop()
        self._pool.shutdown(wait=False)
        if self._reader is not None:
            self._reader.close()
            self._reader = None


class WeightedSampleReader(SampleReader):
    """``label:weight`` first column; values scaled by the weight."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        kwargs["parse"] = _parse_weight
        super().__init__(*args, **kwargs)


_BS_HEAD = struct.Struct("<Qid")  # count, label, weight


class BSparseSampleReader(SampleReader):
    """Binary sparse records (see module docstring for the layout); always
    sparse. Reads fixed-size byte chunks off the Stream instead of lines."""

    def __init__(self, files: str, minibatch: int, input_size: int,
                 sparse: bool = True, max_nnz: int = 64) -> None:
        if not sparse:
            log.fatal("BSparseSampleReader requires sparse data")
        self._stream: Optional[mv_io.Stream] = None
        self._pending = b""
        self._cursor = 0  # consumed prefix of _pending (compact on refill,
        # not per record — slicing per ~20B record would memcpy the whole
        # window each time)
        super().__init__(files, minibatch, input_size, sparse=True,
                         max_nnz=max_nnz)

    def _open_next_file(self, first: bool = False) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        if first:
            self._file_idx = 0
            self._pending = b""
            self._cursor = 0
        if self._file_idx < len(self.files):
            self._stream = mv_io.get_stream(self.files[self._file_idx], "r")
            self._file_idx += 1
        else:
            self._eof = True

    def _next_record(self):
        while not self._eof:
            avail = len(self._pending) - self._cursor
            if avail >= _BS_HEAD.size:
                count, label, weight = _BS_HEAD.unpack_from(
                    self._pending, self._cursor)
                need = _BS_HEAD.size + 8 * count
                if avail >= need:
                    keys = np.frombuffer(self._pending, np.uint64, count,
                                         self._cursor + _BS_HEAD.size)
                    self._cursor += need
                    return label, keys.copy(), weight
            chunk = self._stream.read(1 << 16) if self._stream else b""
            if not chunk:
                if len(self._pending) - self._cursor:
                    log.fatal("bsparse: %d trailing bytes in %s",
                              len(self._pending) - self._cursor,
                              self.files[self._file_idx - 1])
                self._pending = b""
                self._cursor = 0
                self._open_next_file()
            else:
                # compact the consumed prefix only on refill (amortized)
                self._pending = self._pending[self._cursor:] + chunk
                self._cursor = 0
        return None

    def _fill(self, buf: Dict[str, np.ndarray]) -> None:
        with self._io_lock:
            n = 0
            while n < self.minibatch:
                rec = self._next_record()
                if rec is None:
                    break
                label, keys, weight = rec
                buf["y"][n] = label
                k = min(len(keys), self.max_nnz)
                buf["idx"][n, :k] = keys[:k].astype(np.int32)
                buf["idx"][n, k:] = -1
                buf["val"][n, :k] = np.float32(weight)
                buf["val"][n, k:] = 0.0
                n += 1
            buf["count"][...] = n


def write_bsparse(address: str, labels: Sequence[int],
                  keys: Sequence[Sequence[int]],
                  weights: Optional[Sequence[float]] = None) -> None:
    """Produce the bsparse binary format (tooling + tests)."""
    with mv_io.get_stream(address, "w") as stream:
        for i, (label, ks) in enumerate(zip(labels, keys)):
            w = 1.0 if weights is None else float(weights[i])
            stream.write(_BS_HEAD.pack(len(ks), int(label), w))
            stream.write(np.asarray(ks, np.uint64).tobytes())


def make_reader(reader_type: str, files: str, minibatch: int,
                input_size: int, sparse: bool = False,
                max_nnz: int = 64) -> SampleReader:
    """Reference factory ``SampleReader::Get`` keyed on reader_type."""
    if reader_type == "weight":
        return WeightedSampleReader(files, minibatch, input_size,
                                    sparse=sparse, max_nnz=max_nnz)
    if reader_type == "bsparse":
        return BSparseSampleReader(files, minibatch, input_size,
                                   sparse=sparse, max_nnz=max_nnz)
    if reader_type != "default":
        log.fatal("unknown reader_type %r (default|weight|bsparse)",
                  reader_type)
    return SampleReader(files, minibatch, input_size, sparse=sparse,
                        max_nnz=max_nnz)
