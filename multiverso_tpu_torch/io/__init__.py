"""URI-dispatched stream IO (port of ``multiverso_tpu/io/__init__.py``).

Reference capability (not copied): ``URI`` parse + ``Stream`` abstraction
with scheme-dispatched factories (``file://`` local stdio stream), plus a
``TextReader`` line reader (``include/multiverso/io/io.h:24-82``,
``src/io/io.cpp``, ``src/io/local_stream.cpp``).

The factory is an open registry: ``register_scheme`` adds a stream scheme
and ``register_fs`` its directory operations. Checkpoints
(``checkpoint.py``), the word2vec corpus and embedding files and the
logistic-regression readers all read and write through this layer.

Registered here: plain paths, ``file://`` and ``mvfs://`` (the
socket-served remote filesystem, :mod:`~multiverso_tpu_torch.io.mvfs`). A
scheme with no registered factory raises (``log.fatal``); it never falls
back to a local path: the JAX package's ``fsspec`` fallback for cloud
schemes is not ported.
"""

from __future__ import annotations

import io as _pyio
import os
from dataclasses import dataclass
from typing import BinaryIO, Callable, Dict, Optional

from multiverso_tpu_torch import log


@dataclass
class URI:
    """Parsed resource locator: ``scheme://host/path`` (scheme defaults to file)."""

    scheme: str
    host: str
    path: str
    raw: str

    @classmethod
    def parse(cls, address: str) -> "URI":
        if "://" not in address:
            return cls(scheme="file", host="", path=address, raw=address)
        scheme, _, rest = address.partition("://")
        if scheme == "file":
            return cls(scheme="file", host="", path=rest or "/", raw=address)
        host, sep, path = rest.partition("/")
        return cls(scheme=scheme, host=host, path=(sep + path) if sep else "", raw=address)


class Stream:
    """Binary stream interface (reference: ``Stream::Write/Read``)."""

    def write(self, data: bytes) -> int:
        raise NotImplementedError

    def read(self, size: int = -1) -> bytes:
        raise NotImplementedError

    def good(self) -> bool:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        """Durability barrier: on return, everything written so far has
        reached stable storage (fsync where the scheme has one). The WAL's
        ``wal_sync=always`` policy rides this; schemes without a real
        barrier degrade to flush()."""
        self.flush()

    def close(self) -> None:
        pass

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LocalStream(Stream):
    """``file://`` stream over host stdio."""

    def __init__(self, path: str, mode: str = "r") -> None:
        binary_mode = mode if "b" in mode else mode + "b"
        if "w" in mode or "a" in mode:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        self._path = path
        self._fp: Optional[BinaryIO] = None
        try:
            self._fp = open(path, binary_mode)
        except OSError as exc:
            log.error("LocalStream: cannot open %s (%s)", path, exc)

    def write(self, data: bytes) -> int:
        if self._fp is None:
            log.fatal("LocalStream.write on bad stream %s", self._path)
        return self._fp.write(data)

    def read(self, size: int = -1) -> bytes:
        if self._fp is None:
            log.fatal("LocalStream.read on bad stream %s", self._path)
        return self._fp.read(size)

    def good(self) -> bool:
        return self._fp is not None

    def flush(self) -> None:
        if self._fp is not None:
            self._fp.flush()

    def sync(self) -> None:
        if self._fp is not None:
            self._fp.flush()
            os.fsync(self._fp.fileno())

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class MemoryStream(Stream):
    """In-memory stream — used by tests and the format round-trips."""

    def __init__(self, data: bytes = b"") -> None:
        self._buf = _pyio.BytesIO(data)

    def write(self, data: bytes) -> int:
        return self._buf.write(data)

    def read(self, size: int = -1) -> bytes:
        return self._buf.read(size)

    def good(self) -> bool:
        return True

    def seek(self, pos: int) -> None:
        self._buf.seek(pos)

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


_FACTORIES: Dict[str, Callable[[URI, str], Stream]] = {}


def register_scheme(scheme: str, factory: Callable[[URI, str], Stream]) -> None:
    _FACTORIES[scheme] = factory


register_scheme("file", lambda uri, mode: LocalStream(uri.path, mode))


def get_stream(address: str, mode: str = "r") -> Stream:
    """StreamFactory::GetStream parity: dispatch on the URI scheme. A
    scheme with no registered factory is fatal."""
    uri = URI.parse(address)
    factory = _FACTORIES.get(uri.scheme)
    if factory is None:
        log.fatal("Can not support the protocol: %s", uri.scheme)
    return factory(uri, mode)


# -- filesystem operations (directory-level) ---------------------------------
# The checkpoint driver needs more than streams: exists / atomic replace /
# makedirs / listdir on whatever scheme the snapshot directory lives on.

class FileSystem:
    """Directory operations for one scheme (default impl: local files)."""

    def exists(self, address: str) -> bool:
        return os.path.exists(URI.parse(address).path)

    def replace(self, src: str, dst: str) -> None:
        """Atomic rename (the checkpoint commit step)."""
        os.replace(URI.parse(src).path, URI.parse(dst).path)

    def makedirs(self, address: str) -> None:
        os.makedirs(URI.parse(address).path, exist_ok=True)

    def listdir(self, address: str) -> list:
        path = URI.parse(address).path
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def remove(self, address: str) -> None:
        os.remove(URI.parse(address).path)


_FILESYSTEMS: Dict[str, FileSystem] = {"file": FileSystem()}


def register_fs(scheme: str, fs: FileSystem) -> None:
    _FILESYSTEMS[scheme] = fs


def fs_for(address: str) -> FileSystem:
    """FileSystem serving the address's scheme; an unregistered scheme is
    fatal (matching get_stream's dispatch)."""
    fs = _FILESYSTEMS.get(URI.parse(address).scheme)
    if fs is None:
        log.fatal("no filesystem registered for: %s", address)
    return fs


def join(address: str, *names: str) -> str:
    """Scheme-preserving path join (addresses always use '/')."""
    base = address.rstrip("/")
    tail = "/".join(n.strip("/") for n in names)
    return f"{base}/{tail}" if tail else base


class TextReader:
    """Buffered line reader over a Stream (reference: ``TextReader::GetLine``)."""

    def __init__(self, address: str, buf_size: int = 1 << 16) -> None:
        self._stream = get_stream(address, "r")
        self._buf_size = buf_size
        self._pending = b""
        self._eof = False

    def get_line(self) -> Optional[str]:
        while True:
            nl = self._pending.find(b"\n")
            if nl >= 0:
                line, self._pending = self._pending[:nl], self._pending[nl + 1:]
                return line.decode("utf-8", errors="replace").rstrip("\r")
            if self._eof:
                if self._pending:
                    line, self._pending = self._pending, b""
                    return line.decode("utf-8", errors="replace").rstrip("\r")
                return None
            chunk = self._stream.read(self._buf_size)
            if not chunk:
                self._eof = True
            else:
                self._pending += chunk

    def close(self) -> None:
        self._stream.close()


# Second storage scheme: socket-served remote filesystem (the hdfs:// analog).
# Imported last — mvfs.py uses the names defined above.
from multiverso_tpu_torch.io import mvfs  # noqa: E402,F401
