"""Vocabulary, corpus reader and Huffman coding for word embedding training
(port of ``multiverso_tpu/models/vocab.py``; host numpy, the same code).

Reference capability (not copied): the WordEmbedding app's ``Dictionary``
(word→id with min-count pruning), ``Reader`` (token stream over text
blocks) and ``HuffmanEncoder`` (binary tree over word counts for
hierarchical softmax)
(``Applications/WordEmbedding/src/{dictionary,reader,huffman_encoder}.*``).

The corpus is read through ``io.TextReader``, so any registered stream
scheme serves it. Huffman codes/points are padded to ``max_code_length``
with an explicit mask so the HS loss is one masked contraction instead of
per-word variable-length loops.
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from multiverso_tpu_torch import log
from multiverso_tpu_torch.io import TextReader


@dataclass
class Dictionary:
    """Word→id mapping with counts, min-count pruning, frequency-sorted ids
    (id 0 = most frequent) — the layout negative sampling expects."""

    word2id: Dict[str, int] = field(default_factory=dict)
    words: List[str] = field(default_factory=list)
    counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @classmethod
    def build(cls, tokens: Iterable[str], min_count: int = 5) -> "Dictionary":
        counter = Counter(tokens)
        kept = [(w, c) for w, c in counter.items() if c >= min_count]
        kept.sort(key=lambda wc: (-wc[1], wc[0]))
        d = cls()
        d.words = [w for w, _ in kept]
        d.word2id = {w: i for i, w in enumerate(d.words)}
        d.counts = np.array([c for _, c in kept], dtype=np.int64)
        return d

    @classmethod
    def from_text_file(cls, path: str, min_count: int = 5) -> "Dictionary":
        def tokens() -> Iterator[str]:
            reader = TextReader(path)
            try:
                while (line := reader.get_line()) is not None:
                    yield from line.split()
            finally:
                reader.close()

        return cls.build(tokens(), min_count)

    def __len__(self) -> int:
        return len(self.words)

    def encode(self, tokens: Iterable[str]) -> np.ndarray:
        ids = [self.word2id[t] for t in tokens if t in self.word2id]
        return np.array(ids, dtype=np.int32)

    def unigram_cdf(self, power: float = 0.75) -> np.ndarray:
        """Cumulative distribution of counts^power (float32, sums to 1)."""
        p = self.counts.astype(np.float64) ** power
        p /= p.sum()
        return np.cumsum(p).astype(np.float32)

    def keep_probs(self, sample: float = 1e-3) -> np.ndarray:
        """Subsampling keep-probability per word (word2vec formula)."""
        if sample <= 0:
            return np.ones(len(self), np.float32)
        freq = self.counts.astype(np.float64) / self.counts.sum()
        keep = np.minimum(1.0, np.sqrt(sample / np.maximum(freq, 1e-12))
                          + sample / np.maximum(freq, 1e-12))
        return keep.astype(np.float32)


class HuffmanEncoder:
    """Huffman tree over word counts → per-word (codes, points) padded to
    ``max_code_length`` with a validity mask, for hierarchical softmax."""

    def __init__(self, counts: np.ndarray, max_code_length: int = 40) -> None:
        vocab = len(counts)
        if vocab < 2:
            log.fatal("HuffmanEncoder needs vocab >= 2, got %d", vocab)
        # heap items: (count, tiebreak, node_id); leaves are 0..V-1,
        # internal nodes V..2V-2
        heap: List[Tuple[int, int, int]] = [
            (int(c), i, i) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        parent = np.zeros(2 * vocab - 1, dtype=np.int64)
        binary = np.zeros(2 * vocab - 1, dtype=np.int8)
        next_id = vocab
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1] = next_id
            parent[n2] = next_id
            binary[n2] = 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = next_id - 1

        self.max_code_length = max_code_length
        self.codes = np.zeros((vocab, max_code_length), dtype=np.int8)
        self.points = np.zeros((vocab, max_code_length), dtype=np.int32)
        self.code_lengths = np.zeros(vocab, dtype=np.int32)
        for w in range(vocab):
            code: List[int] = []
            pts: List[int] = []
            node = w
            while node != root:
                code.append(int(binary[node]))
                pts.append(int(parent[node]) - vocab)  # internal node index
                node = int(parent[node])
            code.reverse()
            pts.reverse()
            n = min(len(code), max_code_length)
            self.code_lengths[w] = n
            self.codes[w, :n] = code[:n]
            self.points[w, :n] = pts[:n]

    def mask(self) -> np.ndarray:
        """(V, L) float mask of valid code positions."""
        idx = np.arange(self.max_code_length)[None, :]
        return (idx < self.code_lengths[:, None]).astype(np.float32)


def iter_token_blocks(path: str, dictionary: Dictionary,
                      block_tokens: int = 1 << 17) -> Iterator[np.ndarray]:
    """Stream the corpus as blocks of encoded token ids (the reference's
    block loader shape, minus the thread)."""
    reader = TextReader(path)
    buf: List[int] = []
    try:
        while (line := reader.get_line()) is not None:
            for tok in line.split():
                wid = dictionary.word2id.get(tok)
                if wid is not None:
                    buf.append(wid)
            if len(buf) >= block_tokens:
                yield np.array(buf[:block_tokens], dtype=np.int32)
                buf = buf[block_tokens:]
    finally:
        reader.close()
    if buf:
        yield np.array(buf, dtype=np.int32)
