"""Sentence embeddings for the sentence variants (counterpart of
``vmrframe_tpu/data/sentence_encoder.py``).

``HashedBoWEncoder`` maps every word to a fixed pseudo-random vector
(``numpy.random.default_rng`` seeded by the word's crc32) and a sentence to
the mean of its words' vectors: not a semantic model, but deterministic,
of any width, and bit-equal to the JAX package's.  Vectors are cached per
sentence.

``get_sentence_encoder`` returns it.  The JAX package first tries SBERT
(``SBertEncoder``, ``sentence_transformers`` with
``bert-base-nli-mean-tokens``), the route that waits here until that
model's weights are in the repository: nothing is downloaded, so the port
takes the hashed route, which is the one the JAX package takes wherever
SBERT does not load.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


class HashedBoWEncoder:
    def __init__(self, dim: int = 768):
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def encode(self, sentence: str) -> np.ndarray:
        """(dim,) float32: the mean of the sentence's word vectors
        (lower-cased, split on whitespace; ``<empty>`` for no words)."""
        hit = self._cache.get(sentence)
        if hit is not None:
            return hit
        words = sentence.strip().lower().split() or ["<empty>"]
        vecs = [np.random.default_rng(zlib.crc32(w.encode())).standard_normal(self.dim)
                .astype(np.float32) for w in words]
        out = np.mean(vecs, axis=0)
        self._cache[sentence] = out
        return out


def get_sentence_encoder(dim: int = 768) -> HashedBoWEncoder:
    return HashedBoWEncoder(dim)
