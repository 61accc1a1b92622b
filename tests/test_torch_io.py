"""The port's stream layer (``multiverso_tpu_torch.io``) and the word2vec
file readers against the JAX package's.

* ``URI`` parses, ``LocalStream``/``MemoryStream`` and the file system
  operations behave as the JAX package's; a scheme with no registered
  factory raises, and never falls back to a local path.
* ``TextReader`` gives the JAX reader's lines; ``Dictionary.from_text_file``
  and ``iter_token_blocks`` give exactly the JAX package's ids and counts
  on the same seeded corpus file.
* ``save_embeddings`` writes the JAX package's bytes, on a plain path and
  on another registered scheme, and ``load_embeddings`` reads them back.
"""

import os

import numpy as np
import pytest

from multiverso_tpu import io as jio
from multiverso_tpu.models import vocab as jvocab
from multiverso_tpu.models import word2vec as jw

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import io as tio
from multiverso_tpu_torch.models import vocab as tvocab
from multiverso_tpu_torch.models import word2vec as tw


@pytest.mark.parametrize("address", [
    "plain/path.txt", "/abs/path", "file:///tmp/x", "file://", "mvfs://h:9/run/a",
    "gs://bucket", "s3://b/k/x.bin"])
def test_uri_parse_matches_jax(address):
    got, want = tio.URI.parse(address), jio.URI.parse(address)
    assert (got.scheme, got.host, got.path, got.raw) == (
        want.scheme, want.host, want.path, want.raw)


@pytest.mark.parametrize("address", ["gs://bucket/x", "memory://x",
                                     "mvfs://127.0.0.1:1/x", "hdfs://n/x"])
def test_unknown_scheme_raises_and_never_falls_back(tmp_path, address):
    """No fsspec fallback and no local file: the card's machine has no
    fsspec, and a local path under another name would hide a typo.
    ``mvfs://`` is registered now (``io/mvfs.py``): an unreachable server
    gives a bad stream and failing filesystem calls, never a local file."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        if address.startswith("mvfs://"):
            assert not tio.get_stream(address, "w").good()
            with pytest.raises(OSError):
                tio.fs_for(address).exists(address)
            with pytest.raises(mvt.log.FatalError, match="bad stream"):
                tio.TextReader(address).get_line()
            assert os.listdir(tmp_path) == []
            return
        with pytest.raises(mvt.log.FatalError, match="protocol"):
            tio.get_stream(address, "w")
        with pytest.raises(mvt.log.FatalError, match="no filesystem"):
            tio.fs_for(address)
        with pytest.raises(mvt.log.FatalError):
            tio.TextReader(address)
        assert os.listdir(tmp_path) == []
    finally:
        os.chdir(cwd)


def test_local_stream_and_filesystem(tmp_path):
    path = str(tmp_path / "sub" / "dir" / "f.bin")
    with tio.get_stream("file://" + path, "w") as s:   # parents are made
        assert s.good()
        s.write(b"abc")
        s.sync()                                        # fsync
        s.write(b"def")
    with tio.get_stream(path, "r") as s:
        assert s.read(2) == b"ab" and s.read() == b"cdef"
    fs = tio.fs_for(path)
    assert fs.exists(path) and not fs.exists(path + ".x")
    fs.replace(path, path + ".moved")
    assert fs.listdir(str(tmp_path / "sub" / "dir")) == ["f.bin.moved"]
    fs.makedirs("file://" + str(tmp_path / "made"))
    assert os.path.isdir(tmp_path / "made")
    fs.remove(path + ".moved")
    assert fs.listdir(str(tmp_path / "sub" / "dir")) == []
    assert fs.listdir(str(tmp_path / "missing")) == []
    bad = tio.get_stream(str(tmp_path / "missing" / "f"), "r")
    assert not bad.good()
    with pytest.raises(mvt.log.FatalError, match="bad stream"):
        bad.read()
    assert tio.join("file:///a/", "/b/", "c") == jio.join("file:///a/", "/b/", "c")
    assert tio.join("mvfs://h:1/run") == "mvfs://h:1/run"


def test_memory_stream():
    s = tio.MemoryStream()
    s.write(b"hello ")
    s.write(np.arange(3, dtype=np.uint8))  # any buffer
    assert s.getvalue() == b"hello \x00\x01\x02"
    s.seek(0)
    assert s.read(5) == b"hello" and s.good()


def _corpus(path, seed=3, lines=60, vocab=40):
    """A seeded corpus with blank lines, CRLF endings and runs of spaces."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(lines):
        toks = [f"w{t}" for t in np.minimum(rng.zipf(1.4, rng.integers(0, 30)),
                                            vocab)]
        sep = "  " if i % 7 == 0 else " "
        out.append(sep.join(toks) + ("\r" if i % 5 == 0 else ""))
    path.write_bytes("\n".join(out).encode())  # no final newline
    return str(path)


@pytest.mark.parametrize("buf_size", [7, 1 << 16])
def test_text_reader_lines_match_jax(tmp_path, buf_size):
    path = _corpus(tmp_path / "c.txt")

    def lines(mod):
        reader = mod.TextReader(path, buf_size=buf_size)
        out = []
        while (line := reader.get_line()) is not None:
            out.append(line)
        reader.close()
        return out

    got = lines(tio)
    assert got == lines(jio) and len(got) == 60


@pytest.mark.parametrize("min_count", [1, 5])
def test_dictionary_and_token_blocks_match_jax(tmp_path, min_count):
    path = _corpus(tmp_path / "c.txt")
    got = tvocab.Dictionary.from_text_file(path, min_count=min_count)
    want = jvocab.Dictionary.from_text_file(path, min_count=min_count)
    assert got.words == want.words and got.word2id == want.word2id
    assert got.counts.dtype == want.counts.dtype
    np.testing.assert_array_equal(got.counts, want.counts)
    for block in (16, 1 << 17):
        tb = list(tvocab.iter_token_blocks("file://" + path, got, block))
        jb = list(jvocab.iter_token_blocks(path, want, block))
        assert len(tb) == len(jb) >= 1
        for a, b in zip(tb, jb):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("binary", [False, True])
def test_embeddings_bytes_on_every_registered_scheme(tmp_path, monkeypatch,
                                                     binary):
    d = tvocab.Dictionary()
    d.words = ["alpha", "beta", "gamma", "delta"]
    emb = np.random.default_rng(4).normal(size=(5, 6)).astype(np.float32)
    path, jpath = str(tmp_path / "emb"), str(tmp_path / "jemb")
    tw.save_embeddings(d, emb, path, binary=binary)
    jw.save_embeddings(d, emb, jpath, binary=binary)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        want = b.read()
        assert a.read() == want

    # a second scheme: an in-memory store registered for the test
    store = {}

    class Kept(tio.MemoryStream):
        def __init__(self, key, mode):
            super().__init__(store.get(key, b"") if "r" in mode else b"")
            self._key, self._mode = key, mode

        def close(self):
            if "w" in self._mode:
                store[self._key] = self.getvalue()

    monkeypatch.setitem(tio._FACTORIES, "kept",
                        lambda uri, mode: Kept(uri.host + uri.path, mode))
    tw.save_embeddings(d, emb, "kept://bucket/emb", binary=binary)
    assert store["bucket/emb"] == want
    words, mat = tw.load_embeddings("kept://bucket/emb", binary=binary)
    jwords, jmat = jw.load_embeddings(jpath, binary=binary)
    assert words == jwords == d.words
    np.testing.assert_array_equal(mat, jmat)
    if binary:
        np.testing.assert_array_equal(mat, emb[:4])
